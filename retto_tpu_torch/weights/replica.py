"""Full-size Paddle-export ONNX replicas of the reference model suite.

Port copy of ``retto_tpu/weights/replica.py`` (pure numpy, with the port's
``models.common.make_divisible``): the graphs are built from numpy seeds,
so both packages build the same bytes.

The reference's L0 is three ONNX artifacts (build.rs:7-12:
``ch_PP-OCRv4_det_infer.onnx``, ``ch_PP-OCRv4_rec_infer.onnx``,
``ch_ppocr_mobile_v2.0_cls_infer.onnx``) that this environment cannot
fetch (no network).  The idiom-level bridge tests
(tests/test_onnx_bridge.py::TestPaddleExportReplica) cover the exporter's
op patterns on toy blocks; THIS module generates graphs at the real
models' scale — full backbone depths, real channel plans, the 6,625-class
rec head — encoded through the same hand-rolled protobuf codec
(onnx_proto) and run through the same translator (onnx_bridge), so the
first networked run of the actual artifacts exercises no new code path
(VERDICT r3 item 8).

Exporter idioms reproduced (paddle2onnx inference-export conventions):
* Conv carries the folded BatchNorm bias (no BatchNormalization nodes),
* HardSwish is DECOMPOSED as ``x * HardSigmoid(x; alpha=1/6, beta=0.5)``,
* SE gates use GlobalAveragePool -> 1x1 Conv -> Relu -> 1x1 Conv ->
  HardSigmoid -> Mul,
* FPN upsamples are Resize(nearest) with a scales initializer,
* the rec sequence flatten is the dynamic Shape->Gather->Unsqueeze->
  Concat->Reshape chain (shape-polymorphic, like the real export),
* the DB head finishes with two stride-2 ConvTranspose layers + Sigmoid.

Weights are seeded-random at matched fan-in scales — the graphs compute,
they don't read.  One DELIBERATE rehearsal scaffold: the det graph blends
a shallow ink-detector branch (AvgPool of the normalized input) into the
DB logits so random weights still produce a usable text mask; without it
a random deep tower emits a flat map, no boxes form, and the fused
det->cls->rec path downstream of det would never execute.  The scaffold
is 3 extra nodes and is clearly marked; the real artifacts replace the
whole graph, not the scaffold.
"""

from __future__ import annotations

import numpy as np

from ..models.common import make_divisible
from .onnx_proto import encode_model, encode_node

__all__ = ["build_det_replica", "build_cls_replica", "build_rec_replica"]

# MobileNetV3 plans (kernel, expand, out, use_se, act, stride) — the
# reference backbones' block tables (models/mobilenetv3.py mirrors
# PaddleOCR's): large for det, small for cls.
_LARGE_CFG = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_SMALL_CFG = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class _G:
    """Tiny ONNX graph builder over the onnx_proto node encoder."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.nodes: list[bytes] = []
        self.inits: dict[str, np.ndarray] = {}
        self._n = 0

    def name(self, tag: str) -> str:
        self._n += 1
        return f"{tag}_{self._n}"

    def node(self, op: str, ins: list[str], n_out: int = 1, **attrs):
        outs = [self.name(op.lower()) for _ in range(n_out)]
        self.nodes.append(encode_node(op, ins, outs, **attrs))
        return outs[0] if n_out == 1 else outs

    def w(self, arr: np.ndarray) -> str:
        n = self.name("w")
        # np.asarray, NOT ascontiguousarray: the latter promotes 0-d
        # scalars to 1-D, which breaks Gather->Unsqueeze shape idioms
        self.inits[n] = np.asarray(arr)
        return n

    def const(self, arr, dtype=np.float32) -> str:
        return self.w(np.asarray(arr, dtype))

    # ---- layers ------------------------------------------------------ #
    def conv(self, x: str, cin: int, cout: int, k: int, s: int = 1,
             groups: int = 1, act: str | None = None) -> str:
        fan = (cin // groups) * k * k
        wt = (self.rng.normal(size=(cout, cin // groups, k, k))
              / np.sqrt(fan)).astype(np.float32)
        # fused conv-bn: bias present (paddle2onnx folds BN into Conv B)
        b = (self.rng.normal(size=(cout,)) * 0.02).astype(np.float32)
        p = k // 2
        attrs = dict(strides=[s, s], pads=[p, p, p, p])
        if groups != 1:
            attrs["group"] = groups
        y = self.node("Conv", [x, self.w(wt), self.w(b)], **attrs)
        return self.act(y, act)

    def act(self, x: str, kind: str | None) -> str:
        if kind in (None, "none"):
            return x
        if kind == "relu":
            return self.node("Relu", [x])
        # paddle2onnx hardswish decomposition
        hs = self.node("HardSigmoid", [x], alpha=1.0 / 6.0, beta=0.5)
        return self.node("Mul", [x, hs])

    def se(self, x: str, ch: int, reduction: int = 4) -> str:
        mid = make_divisible(ch // reduction, 8)
        gap = self.node("GlobalAveragePool", [x])
        s1 = self.conv(gap, ch, mid, 1, act="relu")
        s2 = self.conv(s1, mid, ch, 1)
        gate = self.node("HardSigmoid", [s2], alpha=0.2, beta=0.5)
        return self.node("Mul", [x, gate])

    def mbv3_unit(self, x: str, cin: int, exp: int, cout: int, k: int,
                  s: int, use_se: bool, act: str) -> str:
        y = self.conv(x, cin, exp, 1, act=act)
        y = self.conv(y, exp, exp, k, s=s, groups=exp, act=act)
        if use_se:
            y = self.se(y, exp)
        y = self.conv(y, exp, cout, 1)
        if s == 1 and cin == cout:
            y = self.node("Add", [x, y])
        return y

    def mbv3_backbone(self, x: str, cfg, scale: float,
                      tap_strides: tuple[int, ...] = ()):
        """Returns (out_name, out_ch, taps: list[(name, ch)] at the
        requested strides — the feature BEFORE each next downsample)."""
        ch = make_divisible(16 * scale, 8)
        y = self.conv(x, 3, ch, 3, s=2, act="hardswish")
        stride = 2
        taps: list[tuple[str, int]] = []
        for i, (k, exp, cout, use_se, act, s) in enumerate(cfg):
            nxt = cfg[i + 1][5] if i + 1 < len(cfg) else 2
            e = make_divisible(exp * scale, 8)
            c = make_divisible(cout * scale, 8)
            y = self.mbv3_unit(y, ch, e, c, k, s, use_se, act)
            ch = c
            stride *= s
            if stride in tap_strides and (nxt == 2 or i == len(cfg) - 1):
                taps.append((y, ch))
        return y, ch, taps

    def resize2(self, x: str, factor: int) -> str:
        scales = self.const([1.0, 1.0, float(factor), float(factor)])
        roi = self.const([], np.float32)
        return self.node("Resize", [x, roi, scales], mode="nearest")

    def model(self, x_name: str, x_shape: list[int], out: str,
              out_shape: list[int]) -> bytes:
        return encode_model(
            self.nodes, self.inits, {x_name: x_shape}, {out: out_shape}
        )


def build_det_replica(seed: int = 11) -> bytes:
    """ch_PP-OCRv4_det-scale graph: MobileNetV3-large x0.5 backbone,
    DBFPN (96 inner / 24 out per level), DB head with two stride-2
    ConvTranspose layers + Sigmoid.  ~1.3M params.  Input f32 NCHW
    [N, 3, H, W], output [N, 1, H, W] (ort_worker.rs:189-198)."""
    g = _G(seed)
    _, _, taps = g.mbv3_backbone("x", _LARGE_CFG, 0.5,
                                 tap_strides=(4, 8, 16, 32))
    assert len(taps) == 4, [t[1] for t in taps]
    inner, out_ch = 96, 24
    ins = [g.conv(t, ch, inner, 1) for (t, ch) in taps]
    p5 = ins[3]
    p4 = g.node("Add", [ins[2], g.resize2(p5, 2)])
    p3 = g.node("Add", [ins[1], g.resize2(p4, 2)])
    p2 = g.node("Add", [ins[0], g.resize2(p3, 2)])
    outs = [g.conv(p, inner, out_ch, 3) for p in (p2, p3, p4, p5)]
    fuse = g.node("Concat", [outs[0], g.resize2(outs[1], 2),
                             g.resize2(outs[2], 4), g.resize2(outs[3], 8)],
                  axis=1)
    # DB head (binarize branch of the PaddleOCR DBHead)
    h = g.conv(fuse, 4 * out_ch, out_ch, 3, act="relu")
    wt = (g.rng.normal(size=(out_ch, out_ch, 2, 2)) * 0.15).astype(np.float32)
    h = g.node("ConvTranspose", [h, g.w(wt)], strides=[2, 2])
    h = g.node("Relu", [h])
    wt2 = (g.rng.normal(size=(out_ch, 1, 2, 2)) * 0.15).astype(np.float32)
    deep = g.node("ConvTranspose", [h, g.w(wt2)], strides=[2, 2])
    # --- rehearsal scaffold (see module docstring): shallow ink branch
    # blended into the logits so the random-weight graph still produces a
    # usable text mask for the downstream pipeline stages -------------- #
    xm = g.node("ReduceMean", ["x"], axes=[1], keepdims=1)
    xs = g.node("AveragePool", [xm], kernel_shape=[5, 5], strides=[1, 1],
                pads=[2, 2, 2, 2])
    ink = g.node("Mul", [xs, g.const(-4.0)])
    ink = g.node("Add", [ink, g.const(-1.0)])
    small = g.node("Mul", [deep, g.const(0.05)])
    logits = g.node("Add", [small, ink])
    y = g.node("Sigmoid", [logits])
    g.nodes.append(encode_node("Identity", [y], ["prob"]))
    return g.model("x", [1, 3, 64, 64], "prob", [1, 1, 64, 64])


def build_cls_replica(seed: int = 12) -> bytes:
    """ch_ppocr_mobile_v2.0_cls-scale graph: MobileNetV3-small x0.35 +
    last conv + GAP + FC + Softmax -> [N, 2] (ort_worker.rs:200-209)."""
    g = _G(seed)
    y, ch, _ = g.mbv3_backbone("x", _SMALL_CFG, 0.35)
    last = make_divisible(576 * 0.35, 8)
    y = g.conv(y, ch, last, 1, act="hardswish")
    y = g.node("GlobalAveragePool", [y])
    y = g.node("Flatten", [y], axis=1)
    wt = (g.rng.normal(size=(last, 2)) / np.sqrt(last)).astype(np.float32)
    b = np.zeros((2,), np.float32)
    y = g.node("Gemm", [y, g.w(wt), g.w(b)])
    y = g.node("Softmax", [y], axis=-1)
    g.nodes.append(encode_node("Identity", [y], ["probs"]))
    return g.model("x", [1, 3, 48, 192], "probs", [1, 2])


def build_rec_replica(seed: int = 13, num_classes: int = 6625,
                      mixer_dim: int = 256, mixer_depth: int = 2) -> bytes:
    """ch_PP-OCRv4_rec-scale graph: LCNet-style depthwise-separable conv
    stages collapsing H 48 -> 3 at T = W/8, a dynamic Shape->Gather->
    Concat->Reshape sequence flatten, ``mixer_depth`` single-head
    attention blocks with LayerNormalization, and the full
    ``num_classes``-way CTC projection + Softmax -> [N, T, C]
    (ort_worker.rs:211-221; dict scale rec_processor.rs:29-46)."""
    g = _G(seed)
    dims = (64, 128, 256, 256)
    y = g.conv("x", 3, dims[0] // 2, 3, s=2, act="hardswish")  # 24 x W/2
    ch = dims[0] // 2
    strides = [(2, 2), (2, 2), (2, 1), (1, 1)]
    for dim, (sh, sw) in zip(dims, strides):
        # depthwise k3 (grouped conv) + pointwise, paddle LCNet block
        fan = 9
        wt = (g.rng.normal(size=(ch, 1, 3, 3)) / np.sqrt(fan)).astype(np.float32)
        b = np.zeros((ch,), np.float32)
        y = g.node("Conv", [y, g.w(wt), g.w(b)], strides=[sh, sw],
                   pads=[1, 1, 1, 1], group=ch)
        y = g.act(y, "hardswish")
        y = g.conv(y, ch, dim, 1, act="hardswish")
        ch = dim
    # H is now 3: collapse to the sequence axis.  AveragePool (3,1) then
    # the exporter's dynamic flatten chain (shape-polymorphic)
    y = g.node("AveragePool", [y], kernel_shape=[3, 1], strides=[3, 1])
    t = g.node("Transpose", [y], perm=[0, 3, 1, 2])  # [N, T, C, 1]
    sh = g.node("Shape", [t])
    d0 = g.node("Gather", [sh, g.const(0, np.int64)], axis=0)
    d1 = g.node("Gather", [sh, g.const(1, np.int64)], axis=0)
    d0u = g.node("Unsqueeze", [d0], axes=[0])
    d1u = g.node("Unsqueeze", [d1], axes=[0])
    tgt = g.node("Concat", [d0u, d1u, g.const([-1], np.int64)], axis=0)
    seq = g.node("Reshape", [t, tgt])  # [N, T, C]
    # project to mixer_dim
    wt = (g.rng.normal(size=(ch, mixer_dim)) / np.sqrt(ch)).astype(np.float32)
    seq = g.node("MatMul", [seq, g.w(wt)])
    ones = np.ones((mixer_dim,), np.float32)
    zeros = np.zeros((mixer_dim,), np.float32)
    for _ in range(mixer_depth):
        n1 = g.node("LayerNormalization", [seq, g.w(ones), g.w(zeros)],
                    axis=-1, epsilon=1e-5)
        q = g.node("MatMul", [n1, g.w((g.rng.normal(size=(mixer_dim, mixer_dim))
                                       / np.sqrt(mixer_dim)).astype(np.float32))])
        k = g.node("MatMul", [n1, g.w((g.rng.normal(size=(mixer_dim, mixer_dim))
                                       / np.sqrt(mixer_dim)).astype(np.float32))])
        v = g.node("MatMul", [n1, g.w((g.rng.normal(size=(mixer_dim, mixer_dim))
                                       / np.sqrt(mixer_dim)).astype(np.float32))])
        kt = g.node("Transpose", [k], perm=[0, 2, 1])
        qk = g.node("MatMul", [q, kt])
        qks = g.node("Mul", [qk, g.const(1.0 / np.sqrt(mixer_dim))])
        attn = g.node("Softmax", [qks], axis=-1)
        ctx = g.node("MatMul", [attn, v])
        seq = g.node("Add", [seq, ctx])
    seq = g.node("LayerNormalization", [seq, g.w(ones), g.w(zeros)],
                 axis=-1, epsilon=1e-5)
    wt = (g.rng.normal(size=(mixer_dim, num_classes))
          / np.sqrt(mixer_dim)).astype(np.float32)
    logits = g.node("MatMul", [seq, g.w(wt)])
    y = g.node("Softmax", [logits], axis=-1)
    g.nodes.append(encode_node("Identity", [y], ["probs"]))
    return g.model("x", [1, 3, 48, 320], "probs", [1, 40, num_classes])
