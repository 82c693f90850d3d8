"""Where bf16 rounds: the port against XLA:CPU's compiled Flax models.

XLA drops the bf16 rounding of a value at the edge of a fusion when the
consuming fusion converts it to float32: a convolution feeding a
BatchNorm, a Dense (product + bias) or a residual add feeding a LayerNorm,
the last Dense feeding the float32 softmax.  The first tests read those
sites from the compiled HLO of the shipped mobile checkpoints and hold the
port's choices to them; the others hold the port's modules to Flax's on
bf16 inputs whose sums are exact in float32 (small integers over powers of
two), so that the order of a sum, which differs between XLA's and
PyTorch's kernels, does not enter the comparison.

Tolerances, each with its reason:
* a ConvBNAct may differ from Flax's on at most 1 in 10,000 outputs, by
  one bf16 step (plus one float32 step of the product, where the result
  cancels to near zero): XLA:CPU contracts the BatchNorm's multiply and add
  into a fused multiply-add, the port does not;
* the Dense -> LayerNorm site is held bit-exact;
* the attention core is held bit-exact: on the CPU the port sums its
  products and its softmax in one fixed order, whatever the intra-op
  thread count."""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from retto_tpu.models import build_cls as j_cls, build_det as j_det, build_rec as j_rec
from retto_tpu.models.common import ConvBNAct as JConvBNAct
from retto_tpu.weights import load_params_meta as j_load
from retto_tpu_torch.models import build_cls, build_det, build_rec
from retto_tpu_torch.models.common import (
    ACTIVATIONS,
    ConvBNAct,
    Dense,
    LayerNorm,
    cast_compute,
)
from retto_tpu_torch.models.svtr import MultiHeadDotProductAttention

J_BUILD = {"det": j_det, "cls": j_cls, "rec": j_rec}
T_BUILD = {"det": build_det, "cls": build_cls, "rec": build_rec}
SHAPE = {"det": (1, 128, 128, 3), "cls": (2, 3, 48, 192), "rec": (2, 3, 48, 320)}
# the Dense modules whose bias add reaches its consumer unrounded in the port
# (models.svtr.RecModel, models.mobilenetv3.ClsModel)
F32_DENSE = {"det": set(), "cls": {"Dense_0"}, "rec": {"Dense_0", "Dense_1"}}


def _compiled_hlo(kind: str) -> str:
    tree, meta = j_load(f"trained_weights/{kind}.npz")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["overrides"].items()}
    extra = {"num_classes": 96} if kind == "rec" else {}
    jm = J_BUILD[kind]("bare", compute_dtype="bfloat16", **extra, **kw)
    x = jnp.zeros(SHAPE[kind], jnp.bfloat16 if kind == "det" else jnp.float32)
    fn = (lambda p, v: jm.apply(p, v, nhwc=True, raw_logits=True)) if kind == "det" else jm.apply
    return jax.jit(fn).lower(tree, x).compile().as_text()


def _parse(txt: str) -> dict[str, list[dict]]:
    comps: dict[str, list[dict]] = {}
    cur = None
    for line in txt.splitlines():
        head = re.match(r"^(ENTRY )?%(\S+) \(.*\{\s*$", line)
        if head:
            cur = comps.setdefault("ENTRY" if head.group(1) else head.group(2), [])
        elif line.startswith("}"):
            cur = None
        elif cur is not None:
            m = re.match(r"\s*(?:ROOT )?%(\S+) = (\w+)\[[^\]]*\]\S* ([\w-]+)\((.*)", line)
            if m:
                name_m = re.search(r'op_name="[^"]*?/([^"]*)"', line)
                cur.append({"name": m.group(1), "ty": m.group(2), "op": m.group(3),
                            "args": re.findall(r"%([\w.\-]+)", m.group(4).split("), ")[0]),
                            "calls": (re.search(r"calls=%([\w.\-]+)", line) or [None, None])[1],
                            "root": line.lstrip().startswith("ROOT"),
                            "op_name": name_m.group(1) if name_m else ""})
    return comps


def _site(op_name: str) -> str:
    """'ClsModel/ConvBNAct_0/Conv_0/conv_general_dilated' -> module path
    'ConvBNAct_0.Conv_0' (the port's attribute path)."""
    parts = [p for p in op_name.split("/")[1:-1] if "." not in p]
    return ".".join(parts)


def _rounded_for_all_consumers(comps, name: str) -> bool:
    """True when every fusion that reads ``name`` first rounds it to bf16."""
    entry = comps["ENTRY"]
    todo, verdicts = [name], []
    while todo:
        cur = todo.pop()
        for user in entry:
            if cur not in user["args"]:
                continue
            if user["op"] in ("bitcast", "copy", "transpose", "reshape"):
                todo.append(user["name"])
            elif user["op"] == "fusion":
                body = comps[user["calls"]]
                for k, a in enumerate(user["args"]):
                    if a != cur:
                        continue
                    param = _param(body, k)
                    verdicts += [i["op"] == "convert" and i["ty"] == "bf16"
                                 for i in body if param in i["args"]]
            else:
                verdicts.append(False)
    return bool(verdicts) and all(verdicts)


def _param(body: list[dict], k: int) -> str:
    params = [i for i in body if i["op"] == "parameter"]
    return next(p["name"] for p in params if p["name"].startswith("param_") and
                int(re.match(r"param_(\d+)", p["name"]).group(1)) == k)


@pytest.mark.parametrize("kind", ["det", "cls", "rec"])
def test_xla_drops_the_rounding_exactly_where_the_port_keeps_float32(kind):
    comps = _parse(_compiled_hlo(kind))
    model = T_BUILD[kind]("mobile")
    convbnact_convs = {f"{n}.Conv_0" for n, m in model.named_modules()
                       if isinstance(m, ConvBNAct)}
    f32_convs, rounded_convs, dots = set(), set(), 0
    for ins in comps["ENTRY"]:
        if ins["op"] not in ("convolution", "dot"):
            continue
        if ins["op_name"].endswith("conv_general_dilated"):  # a 1x1 conv may be a dot
            site = _site(ins["op_name"])
            (rounded_convs if _rounded_for_all_consumers(comps, ins["name"])
             else f32_convs).add(site)
        else:  # every Dense product rounds; its bias add may not (below)
            assert _rounded_for_all_consumers(comps, ins["name"]), ins["op_name"]
            dots += 1
    assert f32_convs and f32_convs <= convbnact_convs
    assert not rounded_convs & convbnact_convs
    assert dots >= (1 if kind == "cls" else 0)
    # the model's own Dense modules whose bias add is used unrounded
    f32_dense = set()
    for ins in comps["ENTRY"]:
        if ins["op"] != "fusion":
            continue
        body = comps[ins["calls"]]
        for add in body:
            m = re.fullmatch(r"\w+Model/(Dense_\d+)/add", add["op_name"])
            if add["op"] != "add" or not m:
                continue
            users = [i for i in body if add["name"] in i["args"]]
            if add["root"] or not all(u["op"] == "convert" and u["ty"] == "bf16"
                                      for u in users):
                f32_dense.add(m.group(1))
    assert f32_dense == F32_DENSE[kind]


def _ints(rng, shape, bound: int, scale: float) -> np.ndarray:
    return (rng.integers(-bound, bound + 1, size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("cin,cout,k,groups,act", [
    (48, 128, 3, 1, "relu"),  # det / cls
    (192, 128, 3, 1, "none"),  # the det residual block's second conv
    (64, 128, 1, 1, "hardswish"),  # the rec pointwise conv
    (64, 64, 3, 64, "hardswish"),  # the rec depthwise conv
])
def test_convbnact_rounds_once_after_the_batchnorm(cin, cout, k, groups, act):
    rng = np.random.default_rng(cin + k)
    x = _ints(rng, (2, 24, 40, cin), 8, 0.25)
    jm = JConvBNAct(cout, k, 1, groups, act, dtype=jnp.bfloat16)
    params = {"Conv_0": {"kernel": _ints(rng, (k, k, cin // groups, cout), 8, 1 / 64)},
              "BatchNorm_0": {"scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                              "bias": rng.normal(size=cout).astype(np.float32)}}
    stats = {"BatchNorm_0": {"mean": rng.normal(size=cout).astype(np.float32),
                             "var": rng.uniform(0.5, 2.0, cout).astype(np.float32)}}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jax.jit(jm.apply)({"params": params, "batch_stats": stats}, xb)
                     .astype(jnp.float32))
    tm = ConvBNAct(cin, cout, k, 1, groups, act)
    with torch.no_grad():
        tm.Conv_0.weight.copy_(torch.from_numpy(params["Conv_0"]["kernel"].transpose(3, 2, 0, 1)))
        bn = tm.BatchNorm_0
        bn.weight.copy_(torch.from_numpy(params["BatchNorm_0"]["scale"]))
        bn.bias.copy_(torch.from_numpy(params["BatchNorm_0"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["BatchNorm_0"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["BatchNorm_0"]["var"]))
    cast_compute(tm, torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tm(xt).float().permute(0, 2, 3, 1).numpy()
        # the placement before: the conv rounded to bf16, then the BatchNorm
        before = ACTIVATIONS[act](bn(tm.Conv_0(xt))).float().permute(0, 2, 3, 1).numpy()
    # one bf16 step of the larger value, plus one float32 step of a product
    # below 256 for results that cancel to near zero
    step = np.maximum(np.abs(got), np.abs(ref)) * 2.0 ** -7 + 2.0 ** -16
    assert np.all(np.abs(got - ref) <= step)
    assert (got != ref).sum() <= ref.size // 10_000
    if groups == 1:
        assert (before != ref).sum() >= ref.size // 100


def test_dense_to_layernorm_site_is_bit_exact():
    """RecModel's Dense_0 -> the first block's LayerNorm: the product rounds
    to bf16, the bias add reaches the LayerNorm unrounded.  Narrowed to 16
    features so that the LayerNorm's sums of the unrounded values and of
    their squares stay exact in float32 (multiples of 1/16 below 63, most
    of them with more significant bits than bf16 keeps)."""
    rng = np.random.default_rng(11)

    class Site(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.LayerNorm(dtype=jnp.bfloat16)(nn.Dense(16, dtype=jnp.bfloat16)(x))

    x = _ints(rng, (2, 40, 64), 1, 1.0)
    kernel, bias = _ints(rng, (64, 16), 1, 0.5), _ints(rng, (16,), 496, 1 / 16)
    scale, shift = rng.uniform(0.5, 1.5, 16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    variables = {"params": {"Dense_0": {"kernel": kernel, "bias": bias},
                            "LayerNorm_0": {"scale": scale, "bias": shift}}}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jax.jit(Site().apply)(variables, xb).astype(jnp.float32))
    dense, ln = Dense(64, 16), LayerNorm(16)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(kernel.T.copy()))
        dense.bias.copy_(torch.from_numpy(bias))
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(shift))
        dense = dense.to(torch.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        got = ln(dense(xt, f32_out=True)).to(torch.bfloat16).float().numpy()
        rounded = ln(dense(xt)).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, ref)
    assert (rounded != ref).sum() > ref.size // 100  # the LayerNorm must not read the rounded sum


def test_attention_core_rounds_where_xla_rounds():
    """Flax's dot_product_attention as XLA:CPU compiles it (the query times
    float32(1 / bf16(sqrt(dh))), the max subtracted in bf16, the float32
    exps summed unrounded, the rounded exps over the rounded sum), on the
    same q, k, v."""
    rng = np.random.default_rng(12)
    # q . k sums multiples of 1/4 below 4, exact in any accumulator
    q, k = (_ints(rng, (2, 40, 8, 15), 1, 0.5) for _ in range(2))
    # v picks one key per feature, so the second product sums one term and
    # the output shows the softmax weights themselves
    v = np.zeros((2, 40, 8, 15), np.float32)
    v[:, np.arange(15) * 2, :, np.arange(15)] = 1.0
    ref = np.asarray(jax.jit(nn.dot_product_attention)(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))).astype(jnp.float32))
    with torch.no_grad():
        got = MultiHeadDotProductAttention.attend(
            *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))).float().numpy()
        qs = torch.from_numpy(q).to(torch.bfloat16) / torch.tensor(np.sqrt(15.0),
                                                                    dtype=torch.bfloat16)
        w = torch.einsum("nqhd,nkhd->nhqk", qs, torch.from_numpy(k).to(torch.bfloat16))
        w = torch.softmax(w.float(), dim=-1).to(torch.bfloat16)
        before = torch.einsum("nhqk,nkhd->nqhd", w, torch.from_numpy(v).to(torch.bfloat16))
    # the placement before (the query divided by sqrt, softmax in float32,
    # rounded once) puts thousands off
    assert np.all(np.abs(got - ref) <= np.abs(ref) * 2.0 ** -7)
    assert (got != ref).sum() == 0
    assert (before.float().numpy() != ref).sum() >= ref.size // 10


def test_attention_core_bits_do_not_depend_on_the_thread_count():
    """The same q, k, v (seeded normals, sums that are not exact in
    float32) through ``attend`` under 1 and under 4 intra-op threads give
    the same bits."""
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.normal(size=(4, 40, 8, 15)).astype(np.float32) * 2)
               .to(torch.bfloat16) for _ in range(3))
    threads = torch.get_num_threads()
    outs = []
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            with torch.no_grad():
                outs.append(MultiHeadDotProductAttention.attend(q, k, v))
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(outs[0], outs[1])


def test_xla_sums_the_mixer_rows_in_windows_of_32():
    """The compiled rec model splits each 120-wide LayerNorm sum into
    reduce-windows of 32 over a zero-padded 128 (padding 4 and 4), and the
    attention softmax's 40 keys into windows of 32 over 64 (padding 12 and
    12): XLA's tree reduction, the order ``models.svtr._xla_row_sum``
    reproduces."""
    windows = set(re.findall(r"reduce-window\(.*window=\{size=([\dx]+) stride=[\dx]+ "
                             r"pad=([\d_x]+)\}", _compiled_hlo("rec")))
    assert ("1x1x32", "0_0x0_0x4_4") in windows
    assert ("1x1x1x32", "0_0x0_0x0_0x12_12") in windows


@pytest.mark.parametrize("n", [20, 32, 40, 96, 120, 1000, 2048])
def test_xla_row_sum_equals_xla_sum_bit_for_bit(n):
    """``_xla_row_sum`` against a jitted ``jnp.sum`` over the last axis on
    seeded rows of mixed magnitude: equal bits, below one window, at one,
    across windows and across two levels of windows; ``torch.sum``'s own
    order differs on most rows."""
    from retto_tpu_torch.models.svtr import _xla_row_sum

    rng = np.random.default_rng(n)
    x = (rng.normal(size=(64, n)) * rng.uniform(0.1, 100, size=(64, 1))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: v.sum(-1))(jnp.asarray(x)))
    np.testing.assert_array_equal(_xla_row_sum(torch.from_numpy(x)).numpy(), ref)
    assert (torch.from_numpy(x).sum(-1).numpy() != ref).sum() >= 8
