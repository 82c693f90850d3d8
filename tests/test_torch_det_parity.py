"""The port's det forward (``DevicePipeline._det_fwd``, device="cpu") against
the JAX ``DevicePipeline._det_fwd`` on the 8 fixture pages, with the shipped
mobile checkpoints: the same planes in, the row-packed mask and the pooled
prob map out.

Counts reached (all stated here because they are the test's bounds): 0
mask pixels and 0 pooled prob bytes differ on all 8 pages.  Before the
port's CPU convs summed in XLA:CPU's order and its CPU BatchNorm took
XLA's rsqrt with a fused multiply-add (``models.common``, the native
``conv_xla``), 5 mask pixels differed over the 8 pages and 43 of 49,152
pooled bytes on page 3, each by one level (ROADMAP Queue 3 item 2).  The
epilogue's arithmetic is XLA's to the bit (tests/test_torch_db_epilogue.py)."""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu.config import SessionConfig as JConfig
from retto_tpu.ops.charset import CharacterDict as JChars
from retto_tpu.pipeline.session import RettoSession as JSession
from retto_tpu_torch import RettoSession, SessionConfig
from retto_tpu_torch.ops.charset import CharacterDict
from retto_tpu_torch.pipeline.stages import _bucket_up

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz"
PAGE = 3


@pytest.fixture(scope="module")
def det_outputs():
    """Per page: (mask bits, prob map, JAX mask bits, JAX prob map, format)."""
    fx = np.load(FIXTURE)
    chars = (ROOT / "trained_weights" / "charset.txt").read_text().splitlines()
    weights = {k: str(ROOT / "trained_weights" / f"{k}.npz") for k in ("det", "cls", "rec")}
    tcfg = SessionConfig()
    tcfg.engine.transfer_format = "yuv420"
    tdp = RettoSession(tcfg, charset=CharacterDict(chars), weights=weights,
                       device="cpu").device_pipeline()
    jcfg = JConfig()
    jcfg.engine.transfer_format = "yuv420"
    out = []
    with JSession(jcfg, charset=JChars(chars), weights=weights).device_pipeline() as jdp:
        for page in fx["pages"]:
            im, planes = tdp._decode_one(np.repeat(page[..., None], 3, axis=2))
            bk = tcfg.buckets
            dh = _bucket_up(im.rh, bk.det_pad_to, bk.det_max_side)
            dw = _bucket_up(im.rw, bk.det_pad_to, bk.det_max_side)
            vs = np.asarray([[im.ah, im.aw]], np.int32)
            vd = np.asarray([[im.rh, im.rw]], np.int32)
            with torch.inference_mode():
                packed, prob, _ = tdp._det_fwd(
                    tuple(torch.from_numpy(p[None]) for p in planes),
                    torch.from_numpy(vs), torch.from_numpy(vd), dh, dw, im.fmt)
            jpacked, jprob, _ = jdp._det_fwd(
                jdp._params["det"], tuple(jnp.asarray(p[None]) for p in planes),
                jnp.asarray(vs), jnp.asarray(vd), dh=dh, dw=dw, fmt=im.fmt)
            # the JAX CPU path packs the mask along W (the XLA fallback of
            # the Pallas kernel), the port along rows: compare the bits
            out.append((np.unpackbits(packed.numpy(), axis=1), prob.numpy(),
                        np.unpackbits(np.asarray(jpacked), axis=2), np.asarray(jprob),
                        im.fmt))
    return out


def test_det_mask_equals_jax_on_page_3(det_outputs):
    mask, _, jmask, _, fmt = det_outputs[PAGE]
    assert fmt == "gray" and mask.shape == jmask.shape == (1, 512, 384)
    assert int((mask != jmask).sum()) == 0


def test_det_mask_against_jax_on_all_pages(det_outputs):
    assert sum(int((m != jm).sum()) for m, _, jm, _, _ in det_outputs) == 0


def test_pooled_prob_map_against_jax_on_page_3(det_outputs):
    _, prob, _, jprob, _ = det_outputs[PAGE]
    assert prob.shape == jprob.shape == (1, 256, 192)
    np.testing.assert_array_equal(prob, jprob)


def test_pooled_prob_map_equals_jax_on_all_pages(det_outputs):
    for _, prob, _, jprob, _ in det_outputs:
        np.testing.assert_array_equal(prob, jprob)
