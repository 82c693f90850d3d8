"""The port's ONNX translator (``retto_tpu_torch.weights.onnx_bridge``)
against the JAX bridge (``retto_tpu.weights.onnx_bridge``) on the same
ONNX bytes and the same numpy inputs from a seed.

One case per op of the JAX registry (all 63), each a small graph run
through JAX ``build_fn`` under ``jax.jit`` and the port's ``build_fn`` on
the CPU.  Tolerances: integer and bool outputs equal (values: JAX holds
int64 as int32); float outputs within 2e-6 of max(1, max |JAX|) for
elementwise and structural ops, 2e-5 for the contractions, pools and
resizes (float32 sums in another order).  Then the integer ``Div``'s
truncation, the host folding of ``Shape -> Gather -> Concat -> Reshape``,
the unsupported-op error, and every case of tests/test_onnx_bridge.py run
against the port."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import test_onnx_bridge as jt
from retto_tpu.weights.onnx_bridge import _Ops as JOps, build_fn as j_build
from retto_tpu.weights.onnx_proto import encode_model, encode_node
from retto_tpu_torch.errors import RettoWeightsError
from retto_tpu_torch.weights import build_fn, load_onnx
from retto_tpu_torch.weights import onnx_proto as port_proto
from retto_tpu_torch.weights.onnx_bridge import _Ops, _FOLDABLE

F32 = np.float32
I64 = np.int64
TIGHT, LOOSE = 2e-6, 2e-5


def port_run(data: bytes, *inputs):
    """The port's translation of ``data`` on the CPU, outputs as numpy."""
    fn, params = build_fn(data)
    with torch.no_grad():
        out = fn({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
                 *[torch.from_numpy(np.asarray(x)) for x in inputs])
    outs = out if isinstance(out, tuple) else (out,)
    res = tuple(o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in outs)
    return res if len(res) > 1 else res[0]


def jax_run(data: bytes, *inputs):
    fn, params = j_build(data)
    out = jax.jit(fn)(params, *inputs)
    outs = out if isinstance(out, tuple) else (out,)
    res = tuple(np.asarray(o) for o in outs)
    return res if len(res) > 1 else res[0]


def _model(nodes, inits, inputs, outputs=("y",)):
    return encode_model(nodes, inits, {k: list(v.shape) for k, v in inputs.items()},
                        {o: [1] for o in outputs})


def _n(op, ins, outs="y", **attrs):
    return encode_node(op, ins, [outs] if isinstance(outs, str) else list(outs), **attrs)


def _case(op: str, rng: np.random.Generator):
    """(model bytes, inputs, tolerance) of the case of ``op``."""
    x = rng.normal(size=(2, 3, 4, 5)).astype(F32)
    y = rng.normal(size=(2, 3, 4, 5)).astype(F32)
    pos = rng.uniform(0.5, 2.0, (2, 3, 4, 5)).astype(F32)
    unary = {"Neg", "Erf", "Tanh", "Relu", "Sigmoid", "HardSwish", "Abs", "Floor",
             "Ceil", "Identity", "Softmax"}
    if op in unary:
        return _model([_n(op, ["x"], axis=1) if op == "Softmax" else _n(op, ["x"])],
                      {}, {"x": x}), [x], TIGHT
    if op in ("Sqrt", "Log", "Exp"):
        return _model([_n(op, ["x"])], {}, {"x": pos}), [pos], TIGHT
    if op in ("Add", "Sub", "Mul", "Div"):
        b = rng.uniform(0.5, 2.0, (5,)).astype(F32)  # broadcast, nonzero
        return _model([_n(op, ["x", "b"])], {"b": b}, {"x": x}), [x], TIGHT
    if op == "Pow":
        e = np.asarray([0.5, 1.0, 2.0, 3.0, -1.0], F32)
        return _model([_n("Pow", ["x", "e"])], {"e": e}, {"x": pos}), [pos], TIGHT
    if op == "LeakyRelu":
        return _model([_n(op, ["x"], alpha=0.1)], {}, {"x": x}), [x], TIGHT
    if op == "HardSigmoid":
        return _model([_n(op, ["x"], alpha=0.3, beta=0.4)], {}, {"x": x}), [x], TIGHT
    if op == "Clip":  # empty optional min, then a min alone
        return _model([_n("Clip", ["x", "", "hi"], "c"), _n("Clip", ["c", "lo"])],
                      {"hi": np.asarray(0.7, F32), "lo": np.asarray(-0.2, F32)},
                      {"x": x}), [x], TIGHT
    if op in ("Equal", "Greater", "Less"):
        xi = np.rint(x * 2).astype(F32)
        yi = np.rint(y * 2).astype(F32)
        return _model([_n(op, ["x", "y"])], {}, {"x": xi, "y": yi}), [xi, yi], TIGHT
    if op == "Where":
        return _model([_n("Greater", ["x", "y"], "c"), _n("Where", ["c", "x", "y"])],
                      {}, {"x": x, "y": y}), [x, y], TIGHT
    if op == "Not":
        return _model([_n("Greater", ["x", "y"], "c"), _n("Not", ["c"])],
                      {}, {"x": x, "y": y}), [x, y], TIGHT
    if op == "Round":  # halves round to even
        h = (rng.integers(-10, 10, (2, 3, 4, 5)) / 2).astype(F32)
        return _model([_n(op, ["x"])], {}, {"x": h}), [h], TIGHT
    if op in ("Min", "Max"):
        z = rng.normal(size=(5,)).astype(F32)
        return _model([_n(op, ["x", "y", "z"])], {"z": z}, {"x": x, "y": y}), [x, y], TIGHT
    if op == "Tile":
        return _model([_n(op, ["x", "r"])], {"r": np.asarray([1, 2, 1, 3], I64)},
                      {"x": x}), [x], TIGHT
    if op == "Dropout":
        return _model([_n(op, ["x"])], {}, {"x": x}), [x], TIGHT
    if op == "Cast":  # float -> int32 truncates; int64 is int32 in JAX
        s = (x * 10).astype(F32)
        return _model([_n("Cast", ["x"], "a", to=6), _n("Cast", ["a"], "b", to=7),
                       _n("Cast", ["b"], "y", to=1)], {}, {"x": s}), [s], TIGHT
    if op == "Shape":
        return _model([_n(op, ["x"])], {}, {"x": x}), [x], TIGHT
    if op == "Constant":
        node = encode_node("Constant", [], ["c"], value=rng.normal(size=(5,)).astype(F32))
        return _model([node, _n("Mul", ["x", "c"])], {}, {"x": x}), [x], TIGHT
    if op == "ConstantOfShape":
        node = encode_node("ConstantOfShape", ["s"], ["c"], value=np.asarray([1.5], F32))
        return _model([node, _n("Add", ["x", "c"])], {"s": np.asarray([4, 5], I64)},
                      {"x": x}), [x], TIGHT
    if op == "Reshape":
        return _model([_n(op, ["x", "s"])], {"s": np.asarray([0, -1, 5], I64)},
                      {"x": x}), [x], TIGHT
    if op == "Transpose":
        return _model([_n(op, ["x"], perm=[0, 3, 1, 2])], {}, {"x": x}), [x], TIGHT
    if op == "Concat":
        return _model([_n(op, ["x", "y"], axis=1)], {}, {"x": x, "y": y}), [x, y], TIGHT
    if op == "Split":
        return _model([_n(op, ["x"], ["a", "b", "y"], axis=3, split=[1, 3, 1])],
                      {}, {"x": x}, outputs=("a", "b", "y")), [x], TIGHT
    if op == "Slice":  # a negative step and an end past the axis
        inits = {"s": np.asarray([3, 0], I64), "e": np.asarray([0, 99], I64),
                 "a": np.asarray([3, 2], I64), "t": np.asarray([-1, 2], I64)}
        return _model([_n(op, ["x", "s", "e", "a", "t"])], inits, {"x": x}), [x], TIGHT
    if op == "Squeeze":
        z = x[:, :1]
        return _model([_n(op, ["x"], axes=[1])], {}, {"x": z}), [z], TIGHT
    if op == "Unsqueeze":
        return _model([_n(op, ["x"], axes=[0, 3])], {}, {"x": x}), [x], TIGHT
    if op == "Gather":  # a negative index wraps once
        idx = np.asarray([[0, -1], [2, 1]], I64)
        return _model([_n(op, ["x", "i"], axis=2)], {"i": idx}, {"x": x}), [x], TIGHT
    if op == "Expand":
        z = rng.normal(size=(3, 1)).astype(F32)
        return _model([_n(op, ["x", "s"])], {"s": np.asarray([2, 3, 4], I64)},
                      {"x": z}), [z], TIGHT
    if op == "Range":
        inits = {"a": np.asarray(1, I64), "b": np.asarray(11, I64), "d": np.asarray(2, I64)}
        z = rng.normal(size=(5,)).astype(F32)
        return _model([_n(op, ["a", "b", "d"], "r"), _n("Cast", ["r"], "f", to=1),
                       _n("Add", ["x", "f"])], inits, {"x": z}), [z], TIGHT
    if op == "Flatten":
        return _model([_n(op, ["x"], axis=2)], {}, {"x": x}), [x], TIGHT
    if op == "Pad":  # constant with a value, then reflect, then edge
        p = np.asarray([0, 1, 2, 1, 0, 0, 1, 2], I64)
        return _model([_n(op, ["x", "p", "v"], "a"), _n(op, ["a", "p"], "b", mode="reflect"),
                       _n(op, ["b", "p"], mode="edge")],
                      {"p": p, "v": np.asarray(0.5, F32)}, {"x": x}), [x], TIGHT
    if op == "ReduceMean":
        return _model([_n(op, ["x"], axes=[1, 2], keepdims=0)], {}, {"x": x}), [x], LOOSE
    if op in ("ReduceSum", "ReduceMax", "ReduceMin"):
        return _model([_n(op, ["x", "a"])], {"a": np.asarray([-1], I64)},
                      {"x": x}), [x], LOOSE
    if op == "ArgMax":
        return _model([_n(op, ["x"], axis=2, keepdims=0)], {}, {"x": x}), [x], TIGHT
    if op == "MatMul":
        w = rng.normal(size=(5, 6)).astype(F32)
        return _model([_n(op, ["x", "w"])], {"w": w}, {"x": x}), [x], LOOSE
    if op == "Gemm":
        a = rng.normal(size=(4, 3)).astype(F32)
        w = rng.normal(size=(5, 4)).astype(F32)
        b = rng.normal(size=(5,)).astype(F32)
        return _model([_n(op, ["x", "w", "b"], transA=1, transB=1, alpha=0.5, beta=2.0)],
                      {"w": w, "b": b}, {"x": a}), [a], LOOSE
    if op == "LayerNormalization":  # population variance over the last axis
        g = rng.uniform(0.5, 1.5, (5,)).astype(F32)
        b = rng.normal(size=(5,)).astype(F32)
        return _model([_n(op, ["x", "g", "b"], axis=-1, epsilon=1e-3)], {"g": g, "b": b},
                      {"x": x}), [x], LOOSE
    if op == "Conv":  # grouped, strided, dilated, asymmetric pads; then SAME
        z = rng.normal(size=(2, 4, 9, 11)).astype(F32)
        w = rng.normal(size=(6, 2, 3, 3)).astype(F32)
        b = rng.normal(size=(6,)).astype(F32)
        w2 = rng.normal(size=(3, 6, 3, 3)).astype(F32)
        return _model([_n(op, ["x", "w", "b"], "c", group=2, strides=[2, 1],
                          dilations=[1, 2], pads=[1, 0, 2, 1]),
                       _n(op, ["c", "w2"], strides=[2, 2], auto_pad="SAME_UPPER")],
                      {"w": w, "b": b, "w2": w2}, {"x": z}), [z], LOOSE
    if op == "ConvTranspose":
        w = rng.normal(size=(3, 2, 3, 3)).astype(F32)
        b = rng.normal(size=(2,)).astype(F32)
        return _model([_n(op, ["x", "w", "b"], strides=[2, 2], pads=[1, 0, 0, 1])],
                      {"w": w, "b": b}, {"x": x}), [x], LOOSE
    if op == "BatchNormalization":
        inits = {"s": rng.uniform(0.5, 1.5, (3,)).astype(F32),
                 "b": rng.normal(size=(3,)).astype(F32),
                 "m": rng.normal(size=(3,)).astype(F32),
                 "v": rng.uniform(0.5, 1.5, (3,)).astype(F32)}
        return _model([_n(op, ["x", "s", "b", "m", "v"], epsilon=1e-3)], inits,
                      {"x": x}), [x], LOOSE
    if op == "MaxPool":  # -inf padding shows on negative inputs
        neg = -pos
        return _model([_n(op, ["x"], kernel_shape=[3, 2], strides=[2, 2],
                          pads=[1, 1, 0, 1])], {}, {"x": neg}), [neg], TIGHT
    if op == "AveragePool":  # divides by the non-pad cells
        return _model([_n(op, ["x"], kernel_shape=[3, 3], strides=[1, 2],
                          pads=[1, 2, 1, 0])], {}, {"x": x}), [x], LOOSE
    if op == "GlobalAveragePool":
        return _model([_n(op, ["x"])], {}, {"x": x}), [x], LOOSE
    if op == "Resize":  # nearest up by scales (half-pixel), linear down by sizes
        return _model([_n(op, ["x", "", "sc"], "u", mode="nearest"),
                       _n(op, ["u", "", "", "sz"], mode="linear")],
                      {"sc": np.asarray([1, 1, 2.5, 1.5], F32),
                       "sz": np.asarray([2, 3, 3, 4], I64)}, {"x": x}), [x], LOOSE
    raise KeyError(op)


OPS = sorted(JOps.registry)


def test_the_port_registers_every_op_of_the_jax_bridge():
    assert len(OPS) == 63
    assert sorted(_Ops.registry) == OPS


@pytest.mark.parametrize("op", OPS)
def test_op_matches_jax_bridge(op):
    rng = np.random.default_rng(OPS.index(op))
    data, inputs, tol = _case(op, rng)
    ref, got = jax_run(data, *inputs), port_run(data, *inputs)
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(refs) == len(gots)
    for r, g in zip(refs, gots):
        assert r.shape == g.shape, (op, r.shape, g.shape)
        if r.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r, err_msg=op)
        else:
            err = float(np.abs(g.astype(np.float64) - r).max()) if r.size else 0.0
            assert err <= tol * max(1.0, float(np.abs(r).max())), (op, err)


def test_integer_div_truncates_toward_zero():
    """ONNX integer Div truncates: on device tensors (the graph input) and
    on folded host values alike, as the JAX bridge does."""
    a = np.asarray([7, -7, 7, -7, 0], I64)
    b = np.asarray([2, 2, -2, -2, 3], I64)
    data = _model([_n("Div", ["x", "b"], "q"), _n("Div", ["c", "b"], "r"),
                   _n("Concat", ["q", "r"], axis=0)],
                  {"b": b, "c": a}, {"x": a})
    got = port_run(data, a)
    np.testing.assert_array_equal(got, [3, -3, -3, 3, 0] * 2)
    np.testing.assert_array_equal(got, jax_run(data, a))


def test_shape_subgraph_folds_on_the_host():
    """Shape -> Gather -> Unsqueeze -> Concat -> Reshape folds with NumPy:
    the reshape target is a static int list and the device sees one
    reshape, for two input shapes."""
    data = _model([_n("Shape", ["x"], "sh"), _n("Gather", ["sh", "i0"], "d0", axis=0),
                   _n("Unsqueeze", ["d0"], "d0u", axes=[0]),
                   _n("Concat", ["d0u", "m1"], "tgt", axis=0),
                   _n("Reshape", ["x", "tgt"])],
                  {"i0": np.asarray(0, I64), "m1": np.asarray([-1], I64)},
                  {"x": np.zeros((2, 3, 4), F32)})
    assert {"Shape", "Gather", "Unsqueeze", "Concat", "Reshape"} <= _FOLDABLE
    for shape in [(2, 3, 4), (5, 2, 2, 3)]:
        x = np.random.default_rng(0).normal(size=shape).astype(F32)
        got = port_run(data, x)
        assert got.shape == (shape[0], int(np.prod(shape[1:])))
        np.testing.assert_array_equal(got, jax_run(data, x))
    fn, params = build_fn(data)
    ops_run = []
    orig = _Ops.registry["Reshape"]
    _Ops.registry["Reshape"] = lambda a, x, s: (ops_run.append(type(s)), orig(a, x, s))[1]
    try:
        fn({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
           torch.zeros((2, 3, 4)))
    finally:
        _Ops.registry["Reshape"] = orig
    assert ops_run == [np.ndarray]


def test_unsupported_op_raises(tmp_path):
    data = _model([_n("TotallyMadeUpOp", ["x"])], {}, {"x": np.zeros(1, F32)})
    path = tmp_path / "m.onnx"
    path.write_bytes(data)
    fn, params = load_onnx(path)
    with pytest.raises(RettoWeightsError, match="TotallyMadeUpOp"):
        fn(params, torch.zeros(1))


def test_dynamic_shape_input_raises():
    """A device tensor at a shape-like position is refused, as in JAX."""
    data = _model([_n("Reshape", ["x", "s"])], {}, {"x": np.zeros(4, F32),
                                                  "s": np.zeros(2, I64)})
    fn, params = build_fn(data)
    with pytest.raises(RettoWeightsError, match="shape-like"):
        fn(params, torch.zeros(4), torch.tensor([2, 2]))


@pytest.fixture
def on_the_port(monkeypatch):
    """tests/test_onnx_bridge.py's cases on the port: its ``run_model`` on
    the port's translator, its codec names on the port's codec."""
    monkeypatch.setattr(jt, "run_model", port_run)
    for name in ("encode_model", "encode_node", "parse_model", "tensor_to_numpy"):
        monkeypatch.setattr(jt, name, getattr(port_proto, name))


@pytest.mark.usefixtures("on_the_port")
class TestWireFormatPort(jt.TestWireFormat):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestOpsPort(jt.TestOps):
    def test_unsupported_op_raises(self):
        data = _model([_n("TotallyMadeUpOp", ["x"])], {}, {"x": np.zeros(1, F32)})
        fn, params = build_fn(data)
        with pytest.raises(RettoWeightsError, match="TotallyMadeUpOp"):
            fn(params, torch.zeros(1))


@pytest.mark.usefixtures("on_the_port")
class TestMatchesOwnModelsPort(jt.TestMatchesOwnModels):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPaddleExportReplicaPort(jt.TestPaddleExportReplica):
    pass
