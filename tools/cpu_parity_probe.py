"""Where the port's bf16 models still differ from XLA:CPU's Flax models, and
why: the measurements behind ROADMAP Queue 3 items 2 and 3.

    JAX_PLATFORMS=cpu python tools/cpu_parity_probe.py [rec] [det] [dw]

Runs on the CPU and compares the JAX package with the port (a diagnostic
beside the tests, which is why it imports both).  Prints one JSON line per
part:

* ``rec``: the mobile rec model on seeded noise (as
  tests/test_torch_models.py): the largest difference relative to the
  largest probability; the share of the LCNet backbone's bf16 features that
  differ in bits; the port's mixer and head fed Flax's own features
  (SVTR blocks' differing outputs, the output's relative difference), with
  the LayerNorm as the port computes it and with XLA's windowed sums
  (``models.svtr._xla_row_sum``) in flax's fast-variance formula; a
  standalone 120-wide LayerNorm's differing outputs either way; and the
  share of float32 inputs where XLA's ``rsqrt`` and ``torch.rsqrt`` differ
  from the correctly rounded value.
* ``det``: each ConvBNAct of the mobile det, fed the Flax model's own
  input to that layer on fixture page 0, against the jitted Flax layer
  (differing outputs, largest difference); for the first layer that
  differs, the same with its conv computed as an explicit float32 im2col
  sum in (kh, kw, cin) order, and with the BatchNorm as a fused
  multiply-add using XLA's ``rsqrt`` for its multiplier.  The port's CPU
  layers now take XLA:CPU's arithmetic (``models.common``: Eigen's blocked
  FMA order for the conv, read from ``XLA_FLAGS=--xla_dump_to`` output,
  where the conv is an HLO ``convolution`` run by the runtime and the
  rsqrt is ``rsqrtps`` plus two Newton steps), and every layer reads 0;
  ``RETTO_NATIVE=0`` gives oneDNN's order and ``torch.rsqrt`` again.
* ``dw``: the tree in which XLA:CPU sums a depthwise conv's (kh, kw) taps,
  read by cancelling each pair of taps (weights 2**30 and -2**30, every
  other tap 1, input 1: an output then counts the taps outside the
  smallest subtree that holds both) and held to ``models.common.
  _DW_TREES``; the port's depthwise conv against XLA on random bf16 data;
  the SE gates' and pointwise convs' HLO ``dot``s [M, K] x [K, N] against
  ``models.common.xla_dot`` (the order ``_xla_dot_order`` reads: M = 1
  sequential, then by shape and M, Eigen's blocking); XLA's windowed sum
  over (H, W) against ``models.common.xla_hw_sum``; and the mobile rec's
  LCNet on the ``rec`` part's noise and on four rendered lines of
  ``testdata/smoke_train.npz``: its features against Flax's, each block
  fed the Flax model's own input to it, and the rec output's largest
  difference relative to its largest probability.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from retto_tpu.models import build_det as j_det, build_rec as j_rec  # noqa: E402
from retto_tpu.models.common import ConvBNAct as JConvBNAct  # noqa: E402
from retto_tpu.weights import load_params_meta as j_load  # noqa: E402
from retto_tpu_torch.models import build_det, build_rec  # noqa: E402
from retto_tpu_torch.models.common import (  # noqa: E402
    ACTIVATIONS, LayerNorm, _same_pads, _xla_dot_order, cast_compute, xla_dot, xla_hw_sum,
)
from retto_tpu_torch.models.svtr import _xla_row_sum  # noqa: E402
from retto_tpu_torch.weights import load_flax_params, load_params_meta  # noqa: E402


def _models(kind: str, j_build, t_build):
    path = ROOT / "trained_weights" / f"{kind}.npz"
    tree, meta = j_load(str(path))
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["overrides"].items()}
    extra = {"num_classes": 96} if kind == "rec" else {}
    jm = j_build("bare", compute_dtype="bfloat16", **extra, **kw)
    flat, _ = load_params_meta(str(path))
    tm = load_flax_params(t_build("bare", compute_dtype="bfloat16", **extra, **kw), flat)
    return jm, tree, cast_compute(tm, torch.bfloat16).eval()


def _xla_layernorm(self, x):
    """flax's fast-variance LayerNorm with XLA's windowed float32 sums."""
    x = x.float()
    inv = 1.0 / x.shape[-1]
    mean = _xla_row_sum(x) * inv
    var = torch.clamp(_xla_row_sum(x * x) * inv - mean * mean, min=0.0)
    mul = torch.rsqrt(var + self.eps)[..., None] * self.weight.float()
    return (x - mean[..., None]) * mul + self.bias.float()


def rec_part() -> dict:
    jm, tree, tm = _models("rec", j_rec, build_rec)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 3, 48, 320)).astype(np.float32)
    ref, state = jax.jit(lambda p, v: jm.apply(p, v, capture_intermediates=True))(
        tree, jnp.asarray(x))
    ref = np.asarray(ref)
    inter = state["intermediates"]

    def flax_out(name):
        return np.array(inter[name]["__call__"][0].astype(jnp.float32))

    out = {"part": "rec", "input": "seeded uniform noise [2, 3, 48, 320]"}
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        out["output_rel_diff"] = float(np.abs(got - ref).max() / np.abs(ref).max())
        feats = tm.LCNetBackbone_0(torch.from_numpy(x)).float().numpy()
        out["backbone_features_differing_share"] = float(
            (feats != flax_out("LCNetBackbone_0")).mean())
        for label, ln_forward in (("port_layernorm", LayerNorm.forward),
                                  ("xla_windowed_layernorm", _xla_layernorm)):
            saved = LayerNorm.forward
            LayerNorm.forward = ln_forward
            try:
                ft = torch.from_numpy(flax_out("LCNetBackbone_0")).to(torch.bfloat16)
                seq32 = tm.Dense_0(ft, f32_out=True)
                seq = seq32.to(ft.dtype)
                blocks = {}
                for name in tm.mixer:
                    seq, seq32 = getattr(tm, name)(seq, seq32)
                    blocks[name] = int((seq.float().numpy() != flax_out(name)).sum())
                logits = tm.Dense_1(tm.LayerNorm_0(seq32).to(seq.dtype), f32_out=True)
                p = torch.softmax(logits, -1).numpy()
            finally:
                LayerNorm.forward = saved
            out[f"mixer_from_flax_features_{label}"] = {
                "block_outputs_differing": blocks, "block_size": int(seq.numel()),
                "output_rel_diff": float(np.abs(p - ref).max() / np.abs(ref).max())}
    rng = np.random.default_rng(5)
    xl = rng.normal(size=(3, 50, 120)).astype(np.float32)
    mod = fnn.LayerNorm(epsilon=1e-6)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(xl))
    ln_ref = np.asarray(jax.jit(mod.apply)(v, jnp.asarray(xl)))
    ln = LayerNorm(120)
    with torch.no_grad():
        out["standalone_layernorm_120_differing"] = {
            "port": int((ln(torch.from_numpy(xl)).numpy() != ln_ref).sum()),
            "xla_windowed": int((_xla_layernorm(ln, torch.from_numpy(xl)).numpy()
                                 != ln_ref).sum()),
            "of": int(ln_ref.size)}
    r = np.random.default_rng(0).uniform(0.01, 10, 100_000).astype(np.float32)
    exact = (1 / np.sqrt(r.astype(np.float64))).astype(np.float32)
    out["rsqrt_not_correctly_rounded_share"] = {
        "xla": float((np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(r))) != exact).mean()),
        "torch": float((torch.rsqrt(torch.from_numpy(r)).numpy() != exact).mean())}
    return out


def det_part() -> dict:
    from retto_tpu_torch import RettoSession, SessionConfig
    from retto_tpu_torch.ops.charset import CharacterDict
    from retto_tpu_torch.pipeline.stages import _bucket_up

    fx = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")
    chars = (ROOT / "trained_weights" / "charset.txt").read_text().splitlines()
    weights = {k: str(ROOT / "trained_weights" / f"{k}.npz") for k in ("det", "cls", "rec")}
    cfg = SessionConfig()
    cfg.engine.transfer_format = "yuv420"
    seen = {}
    with RettoSession(cfg, charset=CharacterDict(chars), weights=weights,
                      device="cpu") as session:
        dp = session.device_pipeline()
        real = dp._det_model.forward

        def spy(x, **kw):
            seen["x"] = x.clone()
            return real(x, **kw)

        dp._det_model.forward = spy
        im, planes = dp._decode_one(np.repeat(fx["pages"][0][..., None], 3, axis=2))
        bk = cfg.buckets
        dh = _bucket_up(im.rh, bk.det_pad_to, bk.det_max_side)
        dw = _bucket_up(im.rw, bk.det_pad_to, bk.det_max_side)
        with torch.inference_mode():
            dp._det_fwd(tuple(torch.from_numpy(p[None]) for p in planes),
                        torch.from_numpy(np.asarray([[im.ah, im.aw]], np.int32)),
                        torch.from_numpy(np.asarray([[im.rh, im.rw]], np.int32)),
                        dh, dw, im.fmt)
    jm, tree, tm = _models("det", j_det, build_det)
    records = []

    def intercept(next_fun, args, kwargs, context):
        y = next_fun(*args, **kwargs)
        if isinstance(context.module, JConvBNAct) and context.method_name == "__call__":
            records.append((context.module.path, context.module.clone(parent=None), args[0]))
        return y

    with fnn.intercept_methods(intercept):
        jm.apply(tree, jnp.asarray(seen["x"].float().numpy()).astype(jnp.bfloat16),
                 nhwc=True, raw_logits=True)

    def sub(d, path):
        for p in path:
            d = d[p]
        return d

    out = {"part": "det", "input": "fixture page 0, its det input from the port's _det_fwd",
           "layers": []}
    first = None
    for path, layer, xin in records:
        variables = {"params": sub(tree["params"], path),
                     "batch_stats": sub(tree["batch_stats"], path)}
        ref = np.asarray(jax.jit(layer.apply)(variables, xin).astype(jnp.float32))
        mod = tm
        for p in path:
            mod = getattr(mod, p)
        xt = torch.from_numpy(np.asarray(xin.astype(jnp.float32))).to(torch.bfloat16)
        xt = xt.permute(0, 3, 1, 2)
        with torch.no_grad():
            got = mod(xt).float().permute(0, 2, 3, 1).numpy()
        n = int((got != ref).sum())
        out["layers"].append({"layer": "/".join(path), "input_nhwc": list(xin.shape),
                              "differing": n, "of": int(ref.size),
                              "max_diff": float(np.abs(got - ref).max())})
        if n and first is None:
            first = (path, mod, xt, ref)
    if first is not None:
        path, mod, xt, ref = first
        conv, bn = mod.Conv_0, mod.BatchNorm_0
        (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
        x = xt.float()
        ph, pw = _same_pads(x.shape[2], kh, sh), _same_pads(x.shape[3], kw, sw)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        w = conv.weight.float()
        oh, ow = (x.shape[2] - kh) // sh + 1, (x.shape[3] - kw) // sw + 1
        acc = torch.zeros((x.shape[0], w.shape[0], oh, ow))
        with torch.no_grad():
            for i in range(kh):
                for j in range(kw):
                    patch = x[:, :, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw]
                    for c in range(x.shape[1]):
                        acc = acc + patch[:, c:c + 1] * w[None, :, c, i, j, None, None]
            xla_rsqrt = torch.from_numpy(np.asarray(jax.jit(jax.lax.rsqrt)(
                jnp.asarray(bn.running_var.float().numpy() + np.float32(bn.eps)))))
            mul = (xla_rsqrt * bn.weight.float())[:, None, None]

            def finish(y):
                y = ACTIVATIONS[mod.act](y.to(conv.weight.dtype))
                return int((y.float().permute(0, 2, 3, 1).numpy() != ref).sum())

            d = acc - bn.running_mean.float()[:, None, None]
            fma = (d.double() * mul.double() + bn.bias.double()[:, None, None]).float()
            out["first_differing"] = {
                "layer": "/".join(path),
                "im2col_khkwcin_conv": finish(bn(acc)),
                "im2col_conv_fma_batchnorm_xla_rsqrt": finish(fma),
                "channel_multipliers_differing_from_torch_rsqrt": int(
                    (xla_rsqrt != torch.rsqrt(bn.running_var.float() + bn.eps)).sum()),
                "channels": int(bn.running_var.numel())}
    return out


def _tree_lca_sizes(tree, k: int) -> np.ndarray:
    """For every pair of leaves, the number of leaves of their smallest
    common subtree."""
    sizes = np.zeros((k, k), int)

    def walk(node) -> list[int]:
        if isinstance(node, int):
            return [node]
        left, right = walk(node[0]), walk(node[1])
        for a in left:
            for b in right:
                sizes[a, b] = sizes[b, a] = len(left) + len(right)
        return left + right

    walk(tree)
    return sizes


def dw_part() -> dict:
    import itertools

    from retto_tpu_torch.models.common import _DW_TREES, _depthwise_f32_cpu

    out = {"part": "dw", "trees": {}, "random": [], "se_dot": []}
    for kk in (3, 5):
        k, c = kk * kk, 16
        pads = _same_pads(12, kk, 1)
        fn = jax.jit(lambda x, w: jax.lax.conv_general_dilated(
            x, w, (1, 1), [pads, _same_pads(16, kk, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=c))
        x = np.ones((2, 12, 16, c), np.float32)
        sizes = np.zeros((k, k), int)
        for a, b in itertools.combinations(range(k), 2):
            w = np.ones((kk, kk, 1, c), np.float32)
            w.reshape(k, c)[a], w.reshape(k, c)[b] = 2.0 ** 30, -(2.0 ** 30)
            y = np.asarray(fn(x, w))[:, kk // 2:-(kk // 2), kk // 2:-(kk // 2)]
            sizes[a, b] = sizes[b, a] = k - int(y.min())
        out["trees"][f"{kk}x{kk}"] = bool((sizes == _tree_lca_sizes(_DW_TREES[k], k)).all())
    rng = np.random.default_rng(0)
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    for (n, h, w_, c, kk, s) in [(2, 24, 160, 32, 3, (2, 2)), (2, 6, 40, 128, 3, (2, 1)),
                                 (3, 16, 16, 72, 5, (2, 2))]:
        x, w = bf(rng.normal(size=(n, h, w_, c))), bf(rng.normal(size=(kk, kk, 1, c)))
        ph, pw = _same_pads(h, kk, s[0]), _same_pads(w_, kk, s[1])
        ref = np.asarray(jax.jit(lambda x, w: jax.lax.conv_general_dilated(
            x, w, s, [ph, pw], dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=c))(x, w))
        got = _depthwise_f32_cpu(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 torch.from_numpy(w).permute(3, 2, 0, 1), s, (*ph, *pw))
        out["random"].append({"nhwc": [n, h, w_, c], "kernel": kk, "stride": list(s),
                              "differing": int((got.permute(0, 2, 3, 1).numpy() != ref).sum())})
    dot = jax.jit(jnp.dot)
    shapes = [(m, c, c // 4) for m in (1, 2, 6, 40, 64) for c in (64, 128, 256, 512)]
    shapes += [(m, c // 4, c) for m in (1, 2, 6, 40, 64) for c in (64, 128, 256, 512)]
    shapes += [(240, 512, 512), (240, 256, 512), (480, 128, 128)]
    for m, k, nn_ in shapes:
        a, w = bf(rng.normal(size=(m, k))), bf(rng.normal(size=(k, nn_)))
        ref = np.asarray(dot(a, w))
        got = xla_dot(torch.from_numpy(a), torch.from_numpy(w)).numpy()
        out["se_dot"].append({"mkn": [m, k, nn_], "order": list(_xla_dot_order(m, k, nn_)),
                              "differing": int((got != ref).sum()), "of": int(ref.size)})
    sums = jax.jit(lambda v: jnp.sum(v, axis=(1, 2)))
    out["hw_sum"] = []
    for shape in [(2, 12, 80, 64), (2, 6, 40, 128), (2, 3, 40, 256), (2, 3, 40, 512),
                  (6, 12, 40, 64), (3, 24, 160, 32)]:
        x = rng.normal(size=shape).astype(np.float32)
        got = xla_hw_sum(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        out["hw_sum"].append({"nhwc": list(shape),
                              "differing": int((got != np.asarray(sums(x))).sum()),
                              "of": int(shape[0] * shape[3])})
    out["lcnet"] = _lcnet_witness()
    return out


def _lcnet_witness() -> list[dict]:
    """The port's LCNet features and rec output against Flax's, and each
    LCNet block fed the Flax model's own input to it."""
    jm, tree, tm = _models("rec", j_rec, build_rec)
    lines = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_train.npz")["rec_lines"][:4]
    lines = lines[:, ::-1, ::-1].transpose(0, 3, 1, 2)  # upright, NCHW
    inputs = {"noise [2, 3, 48, 320]":
              np.random.default_rng(0).uniform(-1, 1, (2, 3, 48, 320)).astype(np.float32),
              "4 rendered lines [4, 3, 48, 512]":
              np.ascontiguousarray((lines / 255.0 - 0.5) / 0.5, np.float32)}
    res = []
    for label, x in inputs.items():
        probs, state = jax.jit(lambda p, v: jm.apply(p, v, capture_intermediates=True))(
            tree, jnp.asarray(x))
        probs = np.asarray(probs)
        inter = state["intermediates"]["LCNetBackbone_0"]

        def flax(node):
            return np.array(node["__call__"][0].astype(jnp.float32))

        def nchw(a):
            return torch.from_numpy(a).to(torch.bfloat16).permute(0, 3, 1, 2)

        ref = flax(inter)
        backbone = tm.LCNetBackbone_0
        with torch.no_grad():
            own = backbone(torch.from_numpy(x)).float().numpy()
            got = tm(torch.from_numpy(x)).numpy()
            blocks, prev = {}, flax(inter["ConvBNAct_0"])
            for name in backbone.blocks:
                out = getattr(backbone, name)(nchw(prev)).float().permute(0, 2, 3, 1).numpy()
                want = flax(inter[name])
                blocks[name] = f"{int((out != want).sum())} of {want.size}"
                prev = want
        res.append({"input": label, "features_differing": int((own != ref).sum()),
                    "of": int(ref.size), "blocks_fed_flax_inputs_differing": blocks,
                    "output_rel_diff": float(np.abs(got - probs).max() / np.abs(probs).max())})
    return res


def main() -> None:
    parts = sys.argv[1:] or ["rec", "det"]
    for part in parts:
        print(json.dumps({"rec": rec_part, "det": det_part, "dw": dw_part}[part]()), flush=True)


if __name__ == "__main__":
    main()
