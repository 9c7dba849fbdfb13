"""The dry run of ``repro_torch.launch`` (``cells``, ``dryrun``,
``flops_probe``, ``hlo_stats``, ``mesh``, ``report``, ``reprobe``) and
``DistributedPoissonSolver.lower``, against ``repro``'s.

A ``"fake"`` process group is made only in a subprocess: a default group
in the pytest worker would change what other tests see.  Three
subprocesses run at once, each with its own timeout: the reference on 8
host devices (its lowered and compiled solves and its cells' argument
shardings), the port on a fake group of 8 ranks (the same solves traced
by ``lower``, the smoke cells, the FLOP counts), and the port's CLI on
the 256-rank production mesh.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 80

# tests/test_plansearch.py's 12 sampled plans: (n, bcs, layout, mesh,
# comm, batch, doubling, relayout, order, dtype)
_PP, _UU, _EE, _OE = ("PER", "PER"), ("UNB", "UNB"), ("EVEN", "EVEN"), \
    ("ODD", "EVEN")
_A = ("deferred", "scheduled", "layout")
PLANS = [
    (16, (_PP,) * 3, "CELL", (2, 4), ("a2a", 1), None, *_A, "float64"),
    (16, (_PP,) * 3, "CELL", (2, 4), ("fused", 1), None, *_A, "float32"),
    (16, (_UU,) * 3, "CELL", (2, 4), ("pipelined", 2), None, *_A,
     "float64"),
    (16, (_UU,) * 3, "CELL", (2, 4), ("pipelined", 2), None, "upfront",
     "scheduled", "layout", "float64"),
    (12, (_EE, _OE, _PP), "NODE", (4, 2), ("overlap", 4, "unpack"), None,
     *_A, "float32"),
    (16, (_UU, _PP, _UU), "CELL", (1, 8), ("overlap", 2), None, "upfront",
     "baseline", "natural", "float64"),
    (16, (_UU,) * 3, "NODE", (8, 1), ("a2a", 1), None, "deferred",
     "scheduled", "natural", "float64"),
    (16, (_PP,) * 3, "CELL", (2, 4), ("pipelined", 4), 3, *_A, "float64"),
    (16, (_PP,) * 3, "CELL", (2, 4), ("overlap", 2), 4, *_A, "float64"),
    (16, (_PP,) * 3, "CELL", (2, 4), ("pipelined", 4, "pack", "grid"), 4,
     *_A, "float64"),
    (17, (_PP,) * 3, "CELL", (2, 4), ("pipelined", 2), None, *_A,
     "float32"),
    (16, (_UU,) * 3, "NODE", (2, 4), ("overlap", 4, "unpack"), 2, *_A,
     "float64"),
]
# tests/test_layout.py's lowered census (P,P,P) n=16 on (2, 4), and
# tests/test_distributed.py's interleave census (U,U,U) n=16 on (2, 4);
# float32 unless named.  Each: (bcs, layout, comm, relayout, order)
_P3, _U3 = (_PP,) * 3, (_UU,) * 3
CENSUS = {
    "scheduled/pack": (_P3, "CELL", ("a2a", 1, "pack"), "scheduled",
                       "layout"),
    "scheduled/unpack": (_P3, "CELL", ("a2a", 1, "unpack"), "scheduled",
                         "layout"),
    "baseline/natural": (_P3, "CELL", ("a2a",), "baseline", "natural"),
    "scheduled/overlap:4": (_P3, "CELL", ("overlap", 4), "scheduled",
                            "layout"),
    "unb/a2a:1": (_U3, "CELL", ("a2a", 1), "scheduled", "layout"),
    "unb/pipelined:4": (_U3, "CELL", ("pipelined", 4), "scheduled",
                        "layout"),
    "unb/overlap:4": (_U3, "CELL", ("overlap", 4), "scheduled", "layout"),
    "unb-node/a2a:1": (_U3, "NODE", ("a2a", 1), "scheduled", "layout"),
}
# compiled by the reference for its transforms' FLOPs
FFT_CASES = ("unb/a2a:1", "scheduled/pack", "unb-node/a2a:1")
SPEC = json.dumps({"plans": PLANS, "census": CENSUS, "fft": FFT_CASES})

_COMMON = r"""
import dataclasses, json, sys
SPEC = json.loads(sys.argv[1])

def solver_kw(bcs, layout, comm, relayout="scheduled", order="layout"):
    return dict(bcs=tuple(tuple(getattr(BCType, b) for b in p) for p in bcs),
                layout=getattr(DataLayout, layout), comm=CommConfig(*comm),
                relayout=relayout, order_policy=order)

def plan_kw(n, bcs, layout, ms, comm, B, dbl, rel, order, dt):
    kw = solver_kw(bcs, layout, comm, rel, order)
    kw.update(doubling=dbl)
    return kw

def smoke_extra(arch):
    sm = get_smoke(arch)
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)}
"""

_REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from repro.configs import LM_ARCHS, arch_shapes, get_smoke
from repro.core.bc import BCType, DataLayout
from repro.core.comm import CommConfig
from repro.distributed.pencil import DistributedPoissonSolver
from repro.launch import hlo_stats
from repro.launch.cells import build_cell
""" + _COMMON + r"""
meshes = {}
def mesh(ms):
    ms = tuple(ms)
    if ms not in meshes:
        meshes[ms] = jax.make_mesh(ms, ("data", "model"))
    return meshes[ms]

def solver(n, ms, kw, dtype="float32"):
    kw = dict(kw)
    bcs = kw.pop("bcs")
    return DistributedPoissonSolver((n,) * 3, 1.0, bcs, mesh=mesh(ms),
                                    lazy_green=True,
                                    dtype=getattr(jnp, dtype), **kw)

out = {"bytes": [], "census": {}, "fft": {}, "args": {}}
for p in SPEC["plans"]:
    n, ms, B = p[0], p[3], p[5]
    ds = solver(n, ms, plan_kw(*p), p[9])
    text = ds.lower(batch=B, local_batch=B is not None).as_text()
    out["bytes"].append([c["bytes"] for c in
                         hlo_stats.comm_bytes_stats(text)["per_collective"]])
for name, c in SPEC["census"].items():
    text = solver(16, (2, 4), solver_kw(*c)).lower().as_text()
    out["census"][name] = [hlo_stats.comm_interleave_stats(text),
                           hlo_stats.transpose_stats(text)]
for name in SPEC["fft"]:
    ds = solver(16, (2, 4), solver_kw(*SPEC["census"][name]))
    out["fft"][name] = hlo_stats.fft_flops(ds.lower().compile().as_text())
def rule_bytes(a):
    # the port's training layout rule, by which it trains and serves: the
    # spec's axes; a dimension the axes do not divide whole
    spec = () if a.sharding is None else tuple(a.sharding.spec)
    sizes = {} if a.sharding is None else dict(a.sharding.mesh.shape)
    n = 1
    for k, d in enumerate(a.shape):
        e = spec[k] if k < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        c = int(np.prod([sizes[x] for x in axes]))
        n *= d // c if d % c == 0 else d
    return n * np.dtype(a.dtype).itemsize

out["rule"], out["serve_rule"] = {}, {}
for arch in LM_ARCHS:
    for sh in arch_shapes(arch):
        cell = build_cell(arch, sh.name, mesh((2, 4)),
                          extra_cfg=smoke_extra(arch))
        out["args"][f"{arch}/{sh.name}"] = sum(
            int(np.prod(a.shape if a.sharding is None
                        else a.sharding.shard_shape(a.shape)))
            * np.dtype(a.dtype).itemsize for a in jax.tree.leaves(cell.args))
        rule = out["rule" if sh.kind == "train" else "serve_rule"]
        rule[f"{arch}/{sh.name}"] = sum(
            rule_bytes(a) for a in jax.tree.leaves(cell.args))
# the dense smoke config at 1, 2 and 3 layers on (2, 4): the matmul
# parameters of a rank's "model" blocks by param_specs (its "data" blocks
# gathered whole), the tied embedding once, and its query heads
from jax.sharding import PartitionSpec
from repro.models import transformer as rtf
out["tp_share"] = {}
for L in (1, 2, 3):
    cfg = dataclasses.replace(get_smoke("qwen3-0.6b"), n_layers=L)
    shapes = jax.eval_shape(
        lambda: rtf.init_params(jax.random.PRNGKey(0), cfg))
    specs = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(
                 rtf.param_specs(cfg, {"data": 2, "model": 4}),
                 is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}
    n, heads = 0, None
    for p, a in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = jax.tree_util.keystr(p)
        local = [d // 4 if k < len(specs[key]) and "model" in (
            (specs[key][k],) if isinstance(specs[key][k], str)
            else specs[key][k] or ()) else d for k, d in enumerate(a.shape)]
        if len(a.shape) - key.startswith("['layers']") >= 2:
            n += int(np.prod(local))
        if key == "['layers']['attn']['wq']":
            heads = local[-2]
    out["tp_share"][L] = [n, heads, cfg.d_head]
print("RESULT " + json.dumps(out))
"""

_PORT_SCRIPT = r"""
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
import chip_smoke
from repro_torch.configs import LM_ARCHS, arch_shapes, get_smoke
from repro_torch.core.bc import BCType, DataLayout
from repro_torch.core.comm import CommConfig
from repro_torch.distributed.pencil import DistributedPoissonSolver
from repro_torch.launch import hlo_stats
from repro_torch.launch.cells import build_cell
from repro_torch.launch.flops_probe import held_bytes, measure
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.plan.costmodel import predict_bytes
import math
""" + _COMMON + r"""
meshes = {}
def mesh(ms):
    ms = tuple(ms)
    if ms not in meshes:
        meshes[ms] = make_local_mesh(*ms, device="cpu")
    return meshes[ms]

def solver(n, ms, kw, dtype="float32", engine="torch"):
    kw = dict(kw)
    bcs = kw.pop("bcs")
    return DistributedPoissonSolver((n,) * 3, 1.0, bcs, mesh=mesh(ms),
                                    lazy_green=True, device="cpu",
                                    engine=engine,
                                    dtype=getattr(torch, dtype), **kw)

out = {"bytes": [], "predicted": [], "census": {}, "fft": {}, "args": {},
       "held": {}, "kernels": {}, "flops": {}}
for p in SPEC["plans"]:
    n, ms, B = p[0], p[3], p[5]
    ds = solver(n, ms, plan_kw(*p), p[9])
    tr = ds.lower(batch=B, local_batch=B is not None)
    out["bytes"].append([c["bytes"] for c in
                         hlo_stats.comm_bytes_stats(tr)["per_collective"]])
    out["predicted"].append(predict_bytes(ds.plan, ms[0], ms[1],
                                          getattr(torch, p[9]), ds.comm,
                                          batch=B))
for name, c in SPEC["census"].items():
    text = solver(16, (2, 4), solver_kw(*c)).lower().as_text()
    out["census"][name] = [hlo_stats.comm_interleave_stats(text),
                           hlo_stats.transpose_stats(text)]
for name in SPEC["fft"]:
    ds = solver(16, (2, 4), solver_kw(*SPEC["census"][name]))
    out["fft"][name] = hlo_stats.fft_flops(ds.lower())
# the hand kernels' calls on one rank, as chip_smoke.py's runs count them
for run, (layout, comm) in {"DIST1_UUU/a2a:1": ("CELL", ("a2a", 1)),
                            "DIST1_UUU/overlap:2": ("CELL", ("overlap", 2)),
                            "DIST1_NODE/a2a:1": ("NODE", ("a2a", 1)),
                            "DIST1_NODE/overlap:2": ("NODE", ("overlap", 2))
                            }.items():
    ds = solver(16, (2, 4), solver_kw(_U3, layout, comm), engine="cuda")
    tr = ds.lower()
    out["kernels"][run] = [dict(tr.kernels), chip_smoke.EXPECTED[run],
                           hlo_stats.op_census(tr, ops=list(tr.kernels))]
for arch in LM_ARCHS:
    for sh in arch_shapes(arch):
        cell = build_cell(arch, sh.name, mesh((2, 4)),
                          extra_cfg=smoke_extra(arch), device="cpu")
        with cell.mode:
            out["held"][f"{arch}/{sh.name}"] = held_bytes(*cell.args)
        out["args"][f"{arch}/{sh.name}"] = cell.spec_bytes
# the dense smoke config's train step at 1, 2 and 3 layers, no remat
extra = dict(smoke_extra("qwen3-0.6b"), remat="none")
for L in (1, 2, 3):
    cell = build_cell("qwen3-0.6b", "train_4k", mesh((2, 4)),
                      extra_cfg=dict(extra, n_layers=L), device="cpu")
    with cell.mode:
        m = measure(cell.fn, *cell.args)
    b, s = cell.args[1]["inputs"].shape
    out["flops"][L] = [m.flops, b, s]
print("RESULT " + json.dumps(out))
""".replace("_U3", repr(_U3))


def _env():
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_COMM_CACHE", None)
    return env


def _start(args):
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(p, what):
    try:
        out, err = p.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        pytest.fail(f"{what}: no result within {TIMEOUT} s")
    assert p.returncode == 0, f"{what}:\n{out[-2000:]}\n{err[-3000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three subprocesses, started together."""
    d = tmp_path_factory.mktemp("dryrun")
    procs = {
        "ref": _start(["-c", _REF_SCRIPT, SPEC]),
        "port": _start(["-c", _PORT_SCRIPT, SPEC]),
        "cli": _start(["-m", "repro_torch.launch.dryrun", "--arch",
                       "qwen3-0.6b", "--shape", "decode_32k", "--mesh",
                       "single", "--device", "cpu", "--out", str(d),
                       "--tag", "t"]),
    }
    res = {k: _finish(p, k) for k, p in procs.items()}
    out = {k: json.loads(res[k].split("RESULT ", 1)[1])
           for k in ("ref", "port")}
    out["cli"] = (res["cli"], d / "t.jsonl")
    return out


# -- (1) the arch config ----------------------------------------------------

def test_poisson_arch_config_fields_match_reference():
    from repro.configs import flups_poisson as ref
    from repro_torch.configs import flups_poisson as mine
    engines = {"xla": "torch", "pallas": "cuda"}
    for a, b in ((mine.CONFIG, ref.CONFIG), (mine.SMOKE, ref.SMOKE)):
        got, want = dataclasses.asdict(a), dataclasses.asdict(b)
        want["engine"] = engines[want["engine"]]
        for d in (got, want):
            d["layout"] = d["layout"].name
            d["bcs"] = tuple(tuple(x.name for x in p) for p in d["bcs"])
        assert got == want
    assert [f.name for f in dataclasses.fields(mine.PoissonArchConfig)] == \
        [f.name for f in dataclasses.fields(ref.PoissonArchConfig)]
    assert mine.PoissonArchConfig("x", 8, None, (), "chat2").engine == \
        "torch"


# -- (2) per-collective bytes -----------------------------------------------

@pytest.mark.parametrize("i", range(len(PLANS)))
def test_lowered_collective_bytes_match_reference_and_predictor(runs, i):
    """``lower`` + ``comm_bytes_stats``: the reference's per-collective
    bytes of its lowered HLO, exactly, and ``predict_bytes``'s."""
    got = runs["port"]["bytes"][i]
    assert got == runs["ref"]["bytes"][i], PLANS[i]
    assert got == runs["port"]["predicted"][i], PLANS[i]
    assert got


# -- (3) interleave and relayout censuses -----------------------------------

@pytest.mark.parametrize("name", sorted(CENSUS))
def test_interleave_and_transpose_census_match_reference(runs, name):
    assert runs["port"]["census"][name] == runs["ref"]["census"][name]


def test_scheduled_solve_has_no_standalone_transpose(runs):
    census = runs["port"]["census"]
    for name in ("scheduled/pack", "scheduled/unpack",
                 "scheduled/overlap:4"):
        ts = census[name][1]
        assert ts["standalone"] == 0 and ts["edge"] == 0, (name, ts)
        assert ts["switch_fused"] == 4, (name, ts)
    base = census["baseline/natural"][1]
    assert base["standalone"] > 0 and base["collectives"] == 4
    il = {k: census[f"unb/{k}"][0] for k in ("a2a:1", "pipelined:4",
                                             "overlap:4")}
    assert il["a2a:1"]["all_to_all"] == 4
    assert il["pipelined:4"]["all_to_all"] == 16
    assert il["overlap:4"]["gaps_with_compute"] > \
        il["pipelined:4"]["gaps_with_compute"]


# -- (4) transform FLOPs ----------------------------------------------------

@pytest.mark.parametrize("name", FFT_CASES)
def test_fft_flops_match_reference(runs, name):
    """The analytic count from the trace equals the reference's from its
    compiled HLO's fft ops, exactly."""
    assert runs["port"]["fft"][name] == runs["ref"]["fft"][name] > 0


@pytest.mark.parametrize("run", ["DIST1_UUU/a2a:1", "DIST1_UUU/overlap:2",
                                 "DIST1_NODE/a2a:1", "DIST1_NODE/overlap:2"])
def test_lowered_kernel_calls_equal_the_smoke_launches(runs, run):
    """``lower`` on engine ``"cuda"``: one rank's kernel calls (the
    wrappers' fake-tensor path, nothing launched) are ``chip_smoke.py``'s
    expected launches for the same plan, and ``op_census`` counts them."""
    calls, expected, census = runs["port"]["kernels"][run]
    assert calls == expected == census


# -- (5) model FLOPs --------------------------------------------------------

def test_model_flops_match_reference():
    from repro.configs import get_config as rgc
    from repro.launch import cells as rcells
    from repro_torch.configs import LM_ARCHS, get_config
    from repro_torch.launch import cells
    for arch in LM_ARCHS:
        mine, ref = get_config(arch), rgc(arch)
        assert cells._active_params(mine) == rcells._active_params(ref)
        for kind in ("train", "prefill", "decode"):
            assert cells.model_flops(mine, 4096, kind) == \
                rcells.model_flops(ref, 4096, kind)


# -- (6) counted FLOPs ------------------------------------------------------

def test_counted_train_flops_affine_in_layers_and_near_6nt(runs):
    """The counterpart of ``test_cost_analysis_undercounts_scan``: the
    port's layers run in a Python loop, so one traced step counts every
    layer -- the count is affine in the layer count, exactly -- and
    within 2% of 6 N T + 12 L B S^2 H d_h on the rank's share of the
    fake (2, 4) mesh (N the matmul parameters of its blocks over "model"
    by the reference's ``param_specs``, the tied embedding once, H its
    query heads there, B its data shard; the norms, softmax and loss are
    not matmuls)."""
    f = {int(k): v for k, v in runs["port"]["flops"].items()}
    assert f[3][0] - f[2][0] == f[2][0] - f[1][0] > 0
    for L, (counted, b, s) in f.items():
        n, h, d_head = runs["ref"]["tp_share"][str(L)]
        formula = 6 * n * b * s + 12 * L * b * s * s * h * d_head
        assert abs(counted / formula - 1.0) < 0.02, (counted, formula)


# -- (7) argument bytes -----------------------------------------------------

def test_cell_argument_bytes_match_reference(runs):
    """Every smoke config and shape on a fake (2, 4) mesh: the spec
    trees' local shapes give the reference's argument bytes exactly (its
    arguments' shard shapes: what ``memory_analysis`` reports; its smoke
    cells do not compile on 8 host devices, a ``DuplicateSpecError`` in
    its lowering).  The port's rank holds exactly as much."""
    ref, port = runs["ref"]["args"], runs["port"]["args"]
    assert set(port) == set(ref) and len(ref) == 32
    for key in ref:
        assert port[key] == ref[key], key
        assert runs["port"]["held"][key] == ref[key], key


def test_train_cell_state_bytes_match_the_layout_rule(runs):
    """Every train cell on the fake (2, 4) mesh holds exactly the training
    layout rule's bytes (``train_step.shard_state_``): the reference's
    argument shard shapes, every "data" and "model" entry kept (the MoE
    experts, the attention heads, the MLP's d_ff, the vocabulary, the
    SSM's d_model and the RG-LRU's d_rnn); the batch its data shard."""
    rule, held = runs["ref"]["rule"], runs["port"]["held"]
    assert rule and len(rule) == sum(k.endswith("train_4k") for k in held)
    for key in rule:
        assert held[key] == rule[key], (key, held[key], rule[key])
        assert held[key] >= runs["ref"]["args"][key], key


def test_serving_cell_bytes_match_the_layout_rule(runs):
    """Every prefill and decode cell on the fake (2, 4) mesh holds exactly
    the training layout rule's bytes (``train_step.shard_params_``): the
    reference's parameter shard shapes; the tokens (and frontend) its
    data shard; a decode cell's caches by ``cache_specs`` (its data
    shard of the batch, the kv heads over "model" where they divide),
    and the position."""
    rule, held = runs["ref"]["serve_rule"], runs["port"]["held"]
    assert rule and set(rule) == {k for k in held
                                  if not k.endswith("train_4k")}
    for key in rule:
        assert held[key] == rule[key], (key, held[key], rule[key])
        assert held[key] >= runs["ref"]["args"][key], key


def test_serving_cells_without_recurrent_layers_hold_the_reference_bytes(
        runs):
    """Every prefill and decode cell, of every family, the SSM's and the
    hybrid's included, holds on the fake (2, 4) mesh exactly the
    reference's argument bytes (its arguments' shard shapes), with no
    layout rule in between."""
    ref, held = runs["ref"]["args"], runs["port"]["held"]
    keys = [k for k in held if not k.endswith("train_4k")]
    assert len(keys) == 22, keys
    for key in keys:
        assert held[key] == ref[key], (key, held[key], ref[key])


# -- (8) the CLI ------------------------------------------------------------

def test_dryrun_cli_one_cell_on_256_fake_ranks(runs):
    stdout, path = runs["cli"]
    assert "[dryrun] OK  qwen3-0.6b/decode_32k/single" in stdout
    rec = json.loads(path.read_text().strip())
    assert rec["status"] == "ok", rec
    assert rec["n_chips"] == 256
    assert rec["roofline"]["t_compute_s"] > 0
    assert rec["cost"]["flops"] > 0
    assert rec["t_compile_s"] is None
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == \
        mem["spec_argument_size_in_bytes"]
    assert rec["op_census"]["aten.bmm"] > 0


# -- (9) report and reprobe -------------------------------------------------

def test_report_and_reprobe_on_the_cli_records(runs, tmp_path, capsys):
    from repro_torch.launch import report
    _, path = runs["cli"]
    report.main(["--glob", str(path)])
    text = capsys.readouterr().out
    assert "(1/1 cells ok)" in text and "fits 80G" in text
    assert "| qwen3-0.6b | decode_32k | ok |" in text
    out = tmp_path / "z.jsonl"
    p = _start(["-m", "repro_torch.launch.reprobe", "--in", str(path),
                "--out", str(out), "--device", "cpu", "--remat", "block"])
    assert "[reprobe] OK qwen3-0.6b/decode_32k single" in _finish(
        p, "reprobe")
    old = json.loads(path.read_text())
    new = json.loads(out.read_text())
    assert new["reprobed"] and new["cost"] == old["cost"]
    assert new["roofline"] == old["roofline"]
