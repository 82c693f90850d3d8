"""The port's ONNX codec copy (``retto_tpu_torch.weights.onnx_proto``)
against the JAX package's (``retto_tpu.weights.onnx_proto``): the same
parse of encoded graphs (nodes, attributes of every type, initializers of
every dtype, value infos), byte-equal encodings, and round trips.  All
comparisons are exact."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import test_onnx_torch_export as jx
from retto_tpu.weights import onnx_proto as jp
from retto_tpu.weights import replica as jrep
from retto_tpu_torch.weights import onnx_proto as tp
from retto_tpu_torch.weights import replica as trep

DTYPES = [np.float32, np.float64, np.float16, np.int64, np.int32, np.int8, np.uint8,
          np.bool_]


def _every_kind(enc) -> bytes:
    """A graph with attributes of every encoded type and initializers of
    every dtype the codec maps, encoded by ``enc`` (a codec module)."""
    rng = np.random.default_rng(0)
    inits = {f"t_{np.dtype(d).name}": (rng.normal(size=(2, 3)) * 5).astype(d) for d in DTYPES}
    inits["scalar"] = np.asarray(3, np.int64)
    inits["empty"] = np.zeros((0,), np.float32)
    nodes = [enc.encode_node("Conv", ["x", "t_float32"], ["c"], strides=[2, -1], group=3,
                             alpha=0.25, mode="reflect", scales=[0.5, 1.5],
                             value=np.arange(4, dtype=np.float32)),
             enc.encode_node("Identity", ["c"], ["y"])]
    return enc.encode_model(nodes, inits, {"x": [1, 3, 8, 8]}, {"y": [1, 3, 4, 4]},
                            opset=17)


def _graphs():
    yield "every_kind", _every_kind(jp)
    yield "det_replica", jrep.build_det_replica()
    yield "cls_replica", jrep.build_cls_replica()
    yield "rec_replica", jrep.build_rec_replica(num_classes=97)
    torch.manual_seed(0)
    yield "torch_export_rec_like", jx._export(jx._RecLike(),
                                              (torch.zeros(1, 3, 16, 64),))


@pytest.mark.parametrize("name,data", list(_graphs()), ids=lambda v: v if isinstance(v, str) else "")
def test_parse_matches_jax(name, data):
    got, ref = tp.parse_model(data), jp.parse_model(data)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for key, t in ref.graph.initializers.items():
        a, b = tp.tensor_to_numpy(got.graph.initializers[key]), jp.tensor_to_numpy(t)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_encodings_are_byte_equal():
    assert _every_kind(tp) == _every_kind(jp)
    assert trep.build_cls_replica() == jrep.build_cls_replica()
    assert trep.build_rec_replica(num_classes=97) == jrep.build_rec_replica(num_classes=97)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_initializer_roundtrip(dtype):
    arr = (np.random.default_rng(1).normal(size=(3, 1, 4)) * 50).astype(dtype)
    data = tp.encode_model([tp.encode_node("Identity", ["w"], ["y"])], {"w": arr}, {},
                           {"y": list(arr.shape)})
    m = tp.parse_model(data)
    back = tp.tensor_to_numpy(m.graph.initializers["w"])
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    assert (m.producer, m.opset) == ("retto-tpu", 13)


def test_attribute_roundtrip():
    node = tp.parse_model(_every_kind(tp)).graph.nodes[0]
    assert node.op_type == "Conv" and node.inputs == ["x", "t_float32"]
    assert node.attrs["strides"] == [2, -1] and node.attrs["group"] == 3
    assert node.attrs["alpha"] == pytest.approx(0.25)
    assert node.attrs["mode"] == "reflect"
    assert node.attrs["scales"] == pytest.approx([0.5, 1.5])
    np.testing.assert_array_equal(tp.tensor_to_numpy(node.attrs["value"]),
                                  np.arange(4, dtype=np.float32))
