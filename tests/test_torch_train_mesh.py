"""The port's sharded train step (``init_train_state``/``make_train_step``
with ``mesh=``) against the JAX mesh trainer, on the CPU: four gloo ranks
in subprocesses over a ``('data', 'model')`` ``DeviceMesh`` of (2, 2), the
``tiny`` rec in float32, three steps of the tool's AdamW schedule on one
global batch of 4 lines.  The JAX side runs ``make_mesh(8,
model_parallel=2)`` (data 4) with the same rules; both compute the global
batch's step, whatever the mesh.

Cases (``CASES``: rule, classes):
* ``default``: JAX's default rule (``{"head": ...}``), which matches no
  parameter of the rec, so nothing is model-sharded; 13 classes;
* ``Dense_1``: ``{"Dense_1": P(None, "model")}``, the CTC head's kernel
  split over 'model', 14 classes (7 + 7), against JAX with that rule;
* ``Dense_1_uneven``: the same rule on 13 classes (7 + 6), as 6,625
  classes split 3,313 + 3,312.  This JAX refuses an uneven sharding
  (``device_put`` and ``jit`` alike: the dim must divide), so the JAX
  figure is the ``default`` case's run, the same initial state and the same
  function of it: a sharding does not change what the step computes;
* one case per further kind of spec, each the port's stored block and
  all-gather at use (``train.trainer._GatherParam``) against JAX with the
  same rule, on 14 classes: ``row`` (``{"Dense_1": P("model", None)}``,
  the Dense kernels' rows), ``conv`` (``{"Conv_0": P(None, None, None,
  "model")}``, every ``Conv_0`` kernel's output channels, the depthwise
  ones included), ``attention`` (``{"MultiHeadDotProductAttention_0":
  P(None, "model")}``: the query/key/value kernels' heads, their biases'
  head width and the output kernel's head width) and ``data``
  (``{"Dense_0": P("data", "model")}``: the kernels' rows over 'data' and
  columns over 'model').

Tolerances (float32; the frameworks and the shard sizes sum in other
orders): losses within 1e-4 relative of JAX's (the bound of
``tests/torch_train_parity.py``) and 1e-6 of the port's unsharded step;
after the three steps each parameter tensor within 1e-3 (JAX) and 2e-4
(unsharded) in norm of the norm of JAX's change, for the tensors whose
first-step gradient is above the roundoff floor of that helper (1% of the
largest gradient norm); BatchNorm running statistics after step 1 within
1e-6 of the global batch's (the port's unsharded step's and JAX's), where
a shard-local BatchNorm is off by more than 1e-3.  The measured figures
are in ``MEASURED``.

``param_shardings`` is held to JAX's on the full-width mobile rec, cls and
det: nothing under the default rule; under ``{"Dense_1": ...}`` the rec's
CTC head kernel and, as the rule is a substring of the Flax path, each
SVTR block's second MLP kernel (``SVTRBlock_i/Dense_1``), in JAX and in
the port alike (the sharded step above splits those too)."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from retto_tpu.models import build_cls as j_cls, build_det as j_det, build_rec as j_rec
from retto_tpu.parallel import make_mesh as j_make_mesh
from retto_tpu.train.losses import ctc_loss as j_ctc
from retto_tpu.train.trainer import (
    init_train_state as j_init,
    make_train_step as j_step,
    param_shardings as j_param_shardings,
)
from retto_tpu.weights.store import _flatten
from retto_tpu_torch.models import build_cls, build_det, build_rec
from retto_tpu_torch.parallel.mesh import P, make_mesh
from retto_tpu_torch.train import (
    ctc_loss,
    init_train_state,
    make_train_step,
    param_shardings,
    warmup_cosine_decay,
)
from retto_tpu_torch.weights import convert_flax_params, export_flax_params, load_flax_params

ROOT = Path(__file__).resolve().parent.parent
LR, STEPS = 1e-3, 3
DENSE_1 = {"Dense_1": P(None, "model")}
GATHERED = {"row": {"Dense_1": P("model", None)},
            "conv": {"Conv_0": P(None, None, None, "model")},
            "attention": {"MultiHeadDotProductAttention_0": P(None, "model")},
            "data": {"Dense_0": P("data", "model")}}
# case -> (port rule, classes, the JAX run it is held to)
CASES = {"default": (None, 13, "default"), "Dense_1": (DENSE_1, 14, "Dense_1"),
         "Dense_1_uneven": (DENSE_1, 13, "default"),
         **{case: (rule, 14, case) for case, rule in GATHERED.items()}}
# gathered case -> {stored parameter: its block's shape on (data 0, model 0)}
# (of the tiny rec: mixer 64 wide, 4 heads, MLP 128, 14 classes)
BLOCKS = {
    "row": {"Dense_1.parametrizations.weight.original": (14, 32),
            "SVTRBlock_0.Dense_1.parametrizations.weight.original": (64, 64)},
    "conv": {"LCNetBackbone_0.ConvBNAct_0.Conv_0.parametrizations.weight.original":
             (8, 3, 3, 3),
             "LCNetBackbone_0.DSConv_0.ConvBNAct_0.Conv_0.parametrizations.weight.original":
             (8, 1, 3, 3)},
    "attention": {
        "SVTRBlock_0.MultiHeadDotProductAttention_0.parametrizations.in_proj_weight.original":
        (96, 64),
        "SVTRBlock_0.MultiHeadDotProductAttention_0.parametrizations.in_proj_bias.original":
        (96,),
        "SVTRBlock_0.MultiHeadDotProductAttention_0.out_proj.parametrizations.weight.original":
        (64, 32)},
    "data": {"Dense_0.parametrizations.weight.original": (32, 64),
             "SVTRBlock_0.Dense_0.parametrizations.weight.original": (64, 32)},
}
# case -> (loss vs JAX, loss vs unsharded, params vs JAX, params vs unsharded,
# batch stats vs global), the largest figure measured over the three steps and
# the four ranks; a shard-local BatchNorm's statistics are 1.8e-2 off
MEASURED = {"default": (5.0e-6, 2.2e-7, 5.2e-5, 1.1e-5, 6.0e-8),
            "Dense_1": (5.2e-6, 0.0, 5.5e-5, 3.2e-5, 6.0e-8),
            "Dense_1_uneven": (4.9e-6, 1.1e-7, 5.2e-5, 8.0e-6, 6.0e-8)}


def _batch():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (4, 3, 48, 64)).astype(np.float32)
    labels = rng.integers(1, 13, (4, 4)).astype(np.int32)
    lengths = np.array([4, 2, 3, 1], np.int32)
    labels *= np.arange(4)[None, :] < lengths[:, None]
    return x, labels, lengths


def _forward(m, v):
    return m(v, return_logits=True)


_WORKER = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[4])
from retto_tpu_torch.parallel import distributed as dist
from retto_tpu_torch.parallel.mesh import P
from retto_tpu_torch.models import build_rec
from retto_tpu_torch.train import ctc_loss, init_train_state, make_train_step, warmup_cosine_decay
from retto_tpu_torch.weights import export_flax_params, load_flax_params

port, rank, data = sys.argv[1], int(sys.argv[2]), np.load(sys.argv[3])
assert dist.initialize(f"127.0.0.1:{port}", 4, rank, device="cpu", timeout_s=120)
mesh = dist.global_mesh(model_parallel=2)
x = torch.from_numpy(data["x"])
rest = [torch.from_numpy(data["labels"]), torch.from_numpy(data["lengths"])]
dense_1 = {"Dense_1": P(None, "model")}
gathered = {"row": {"Dense_1": P("model", None)},
            "conv": {"Conv_0": P(None, None, None, "model")},
            "attention": {"MultiHeadDotProductAttention_0": P(None, "model")},
            "data": {"Dense_0": P("data", "model")}}
out = {}
for case, rules, n in (("default", None, 13), ("Dense_1", dense_1, 14),
                       ("Dense_1_uneven", dense_1, 13),
                       *((c, r, 14) for c, r in gathered.items())):
    flat = {k.split(":", 2)[2]: data[k] for k in data.files if k.startswith(f"init:{n}:")}
    model = load_flax_params(build_rec("tiny", num_classes=n, compute_dtype=None), flat)
    state = init_train_state(model, warmup_cosine_decay(float(data["lr"]), 1, 3), device="cpu",
                             mesh=mesh, rules=rules)
    step = make_train_step(model, ctc_loss, forward=lambda m, v: m(v, return_logits=True),
                           mesh=mesh)
    losses = []
    for i in range(3):
        state, loss = step(state, x, *rest)
        losses.append(float(loss))
        if i == 0:
            for name, b in model.named_buffers():
                out[f"{case}:stats:{name}"] = b.numpy().copy()
    out[f"{case}:losses"] = np.asarray(losses)
    out[f"{case}:head_rows"] = np.asarray(model.Dense_1.weight.shape[0])
    for name, prm in model.named_parameters():
        out[f"{case}:block:{name}"] = np.asarray(prm.shape)
    for k, v in export_flax_params(model).items():
        out[f"{case}:params:{k}"] = v
np.savez(sys.argv[5], rank=rank, data_index=mesh.get_local_rank("data"),
         model_index=mesh.get_local_rank("model"), **out)
print("WORKER_DONE", rank, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_run(x, labels, lengths, rules, num_classes):
    jm = j_rec("tiny", num_classes=num_classes, compute_dtype=None)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, LR, 1, STEPS), weight_decay=1e-4)
    mesh = j_make_mesh(8, model_parallel=2)
    state = j_init(jm, tx, x, seed=0, mesh=mesh, rules=rules)
    init = _flatten({"params": state.params, "batch_stats": state.batch_stats})
    init = {k: np.asarray(v) for k, v in init.items()}

    def apply(variables, v, train=False, mutable=None):
        return jm.apply(variables, v, train=train, mutable=mutable, return_logits=True)

    step = j_step(apply, j_ctc, tx, mesh=mesh)
    losses, stats1 = [], None
    for i in range(STEPS):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(lengths))
        losses.append(float(loss))
        if i == 0:
            stats1 = _flatten({"batch_stats": state.batch_stats})
            # the first-step gradients (rate 0: Adam's first moment is 0.1 g);
            # those below 1% of the largest norm are roundoff
            grads = {k: float(np.linalg.norm(v)) / 0.1
                     for k, v in _flatten({"params": state.opt_state[0].mu}).items()}
            roundoff = {k for k, g in grads.items() if g < 1e-2 * max(grads.values())}
    head = state.params["Dense_1"]["kernel"].sharding.spec
    final = {k: np.asarray(v) for k, v in _flatten({"params": state.params}).items()}
    return init, losses, stats1, final, head, roundoff


def _port_unsharded(init, x, labels, lengths, rows=None):
    n = init["params::Dense_1::bias"].shape[0]
    tm = load_flax_params(build_rec("tiny", num_classes=n, compute_dtype=None), init)
    state = init_train_state(tm, warmup_cosine_decay(LR, 1, STEPS), device="cpu")
    step = make_train_step(tm, ctc_loss, forward=_forward)
    rest = (torch.from_numpy(labels), torch.from_numpy(lengths))
    xt = torch.from_numpy(x)
    if rows is not None:  # one forward of a shard-local BatchNorm: its statistics
        with torch.no_grad():
            tm.train()
            tm(xt[rows], return_logits=True)
        return {n: b.numpy().copy() for n, b in tm.named_buffers()}
    losses, stats1 = [], None
    for i in range(STEPS):
        state, loss = step(state, xt, *rest)
        losses.append(float(loss))
        if i == 0:
            stats1 = {n: b.numpy().copy() for n, b in tm.named_buffers()}
    return losses, stats1, export_flax_params(tm)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX at make_mesh(8, model_parallel=2) per case, the port unsharded,
    and the four gloo workers (both cases in one launch)."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    x, labels, lengths = _batch()
    jrule = {"Dense_1": jax.sharding.PartitionSpec(None, "model")}
    jax_runs = {"default": _jax_run(x, labels, lengths, None, 13),
                "Dense_1": _jax_run(x, labels, lengths, jrule, 14)}
    for case, rule in GATHERED.items():
        jax_runs[case] = _jax_run(x, labels, lengths, _jax_rules(rule), 14)
        for k, v in jax_runs[case][0].items():  # a sharding does not change the init
            np.testing.assert_array_equal(v, jax_runs["Dense_1"][0][k])
    with pytest.raises(ValueError, match="divisible"):  # JAX: no uneven shards
        _jax_run(x, labels, lengths, jrule, 13)
    inits = {13: jax_runs["default"][0], 14: jax_runs["Dense_1"][0]}
    np.savez(tmp / "data.npz", x=x, labels=labels, lengths=lengths, lr=LR,
             **{f"init:{n}:{k}": v for n, init in inits.items() for k, v in init.items()})
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(r), str(tmp / "data.npz"), str(ROOT),
         str(tmp / f"rank{r}.npz")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env, text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_DONE" in out, err[-3000:]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return {"jax": jax_runs, "inits": inits, "batch": (x, labels, lengths),
            "unsharded": {n: _port_unsharded(init, x, labels, lengths)
                          for n, init in inits.items()},
            "ranks": ranks}


def _jax_rules(rules):
    return {k: jax.sharding.PartitionSpec(*v) for k, v in rules.items()}


def _rank_params(ranks, case):
    """The full parameters, from the ranks of data index 0 (a kernel split
    over 'model' joined along its Flax [D, C] last axis); asserts that every
    replica holds the same values."""
    pre = f"{case}:params:"
    by = {(int(r["data_index"]), int(r["model_index"])): r for r in ranks}
    full = {}
    for k in (k for k in by[0, 0] if k.startswith(pre)):
        split = case.startswith("Dense_1") and k.endswith("Dense_1::kernel")
        for d, m in ((1, 0), (0, 1), (1, 1)):
            ref = by[0, m if split else 0][k]
            np.testing.assert_array_equal(by[d, m][k], ref, err_msg=f"{k} {d} {m}")
        full[k[len(pre):]] = (np.concatenate([by[0, 0][k], by[0, 1][k]], axis=-1) if split
                              else by[0, 0][k])
    return full


@pytest.mark.parametrize("case", CASES)
def test_sharded_losses_match_jax_and_unsharded(runs, case):
    _, n, jcase = CASES[case]
    jlosses = runs["jax"][jcase][1]
    ulosses = runs["unsharded"][n][0]
    for r in runs["ranks"]:
        got = r[f"{case}:losses"]
        for g, j, u in zip(got, jlosses, ulosses):
            assert abs(g - j) / abs(j) <= 1e-4, (case, got, jlosses)
            assert abs(g - u) / abs(u) <= 1e-6, (case, got, ulosses)


@pytest.mark.parametrize("case", CASES)
def test_sharded_params_match_jax_and_unsharded(runs, case):
    _, n, jcase = CASES[case]
    ranks = runs["ranks"]
    rows = {int(r["model_index"]): int(r[f"{case}:head_rows"]) for r in ranks}
    assert rows == {"default": {0: 13, 1: 13}, "Dense_1": {0: 7, 1: 7},
                    "Dense_1_uneven": {0: 7, 1: 6}}.get(case, {0: 14, 1: 14})
    first = next(r for r in ranks if int(r["data_index"]) == int(r["model_index"]) == 0)
    for name, shape in BLOCKS.get(case, {}).items():
        assert tuple(first[f"{case}:block:{name}"]) == shape, (case, name)
    if case == "Dense_1":
        assert runs["jax"][case][4] == jax.sharding.PartitionSpec(None, "model")
    mine = _rank_params(ranks, case)
    start = runs["inits"][n]
    jfinal = runs["jax"][jcase][3]
    ufinal = runs["unsharded"][n][2]
    moved = {k: float(np.linalg.norm(jfinal[k] - start[k])) for k in jfinal}
    for k, ref in jfinal.items():
        if k in runs["jax"][jcase][5]:
            continue
        assert mine[k].shape == ref.shape, (k, mine[k].shape)
        dj = float(np.linalg.norm(mine[k] - ref)) / moved[k]
        du = float(np.linalg.norm(mine[k] - ufinal[k])) / moved[k]
        assert dj <= 1e-3 and du <= 2e-4, (case, k, dj, du)


def test_batchnorm_statistics_are_global(runs):
    """After step 1 every rank's running statistics are the global batch's
    (the port's unsharded step and JAX's); a BatchNorm over one shard's
    rows lands far from them."""
    x, labels, lengths = runs["batch"]
    for case, (_, n, jcase) in CASES.items():
        ustats = runs["unsharded"][n][1]
        jstats = convert_flax_params(runs["jax"][jcase][2])
        local = _port_unsharded(runs["inits"][n], x, labels, lengths, rows=slice(0, 2))
        assert max(float(np.abs(local[k] - ustats[k]).max()) for k in ustats) > 1e-3
        for r in runs["ranks"]:
            for k, ref in ustats.items():
                got = r[f"{case}:stats:{k}"]
                assert float(np.abs(got - ref).max()) <= 1e-6, (case, k)
                assert float(np.abs(got - jstats[k].numpy()).max()) <= 1e-6, (case, k)


@pytest.mark.parametrize("kind", ["rec", "cls", "det"])
def test_param_shardings_pick_jax_parameters(kind):
    """On the full-width mobile models: JAX's ``param_shardings`` and the
    port's pick the same parameters, none by default, ``Dense_1``'s kernel
    alone (rec) under the explicit rule."""
    jb, tb = {"rec": (j_rec, build_rec), "cls": (j_cls, build_cls),
              "det": (j_det, build_det)}[kind]
    jm = jb("mobile", compute_dtype=None)
    shape = {"rec": (1, 3, 48, 320), "cls": (1, 3, 48, 192), "det": (1, 3, 64, 64)}[kind]
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros(shape)))["params"]
    jmesh = j_make_mesh(8, model_parallel=2)
    tm = tb("mobile", compute_dtype=None)
    tmesh = make_mesh(devices=[torch.device("cpu")] * 8, model_parallel=2)
    shapes = {_key(path): leaf.shape for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    for jrules, trules in ((None, None), ({"Dense_1": jax.sharding.PartitionSpec(None, "model")},
                                          {"Dense_1": P(None, "model")})):
        sh = jax.tree_util.tree_leaves_with_path(j_param_shardings(params, jmesh, jrules))
        jpicked = {_key(path) for path, v in sh if v.spec != jax.sharding.PartitionSpec()}
        # the picked Flax leaves as state-dict names
        jnames = set(convert_flax_params({k: np.zeros(shapes[k]) for k in jpicked}))
        tnames = {k for k, v in param_shardings(tm, tmesh, trules).items() if any(v)}
        assert tnames == jnames, (kind, tnames, jnames)
        if trules and kind == "rec":
            # the substring also names each SVTR block's second MLP Dense
            assert tnames == {"Dense_1.weight", *(f"SVTRBlock_{i}.Dense_1.weight" for i in
                                                  range(len(tm.mixer)))}
        else:
            assert tnames == set()


def _key(path) -> str:
    return "::".join(["params", *(str(getattr(p, "key", p)) for p in path)])


def test_gathered_specs_bit_equal_at_world_size_one(monkeypatch):
    """One gloo rank (mesh (1, 1)) under every gathered spec at once: the
    stored blocks are whole, and three steps give the unsharded step's
    losses and parameters bit for bit."""
    from retto_tpu_torch.parallel import distributed as dist
    import torch.distributed as tdist

    monkeypatch.setattr(dist, "_initialized", False)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    x, labels, lengths = _batch()
    torch.manual_seed(0)
    init = export_flax_params(build_rec("tiny", num_classes=13, compute_dtype=None))
    want_losses, _, want = _port_unsharded(init, x, labels, lengths)
    assert dist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu", timeout_s=60)
    try:
        mesh = dist.global_mesh()
        rules = {k: v for rule in GATHERED.values() for k, v in rule.items()}
        tm = load_flax_params(build_rec("tiny", num_classes=13, compute_dtype=None), init)
        state = init_train_state(tm, warmup_cosine_decay(LR, 1, STEPS), device="cpu",
                                 mesh=mesh, rules=rules)
        stored = [n for n, _ in tm.named_parameters() if n.endswith(".original")]
        assert len(stored) >= 4 + 2 * len(tm.mixer)
        step = make_train_step(tm, ctc_loss, forward=_forward, mesh=mesh)
        rest = (torch.from_numpy(labels), torch.from_numpy(lengths))
        losses = [float(step(state, torch.from_numpy(x), *rest)[1]) for _ in range(STEPS)]
        got = export_flax_params(tm)
    finally:
        tdist.destroy_process_group()
    assert losses == want_losses
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
