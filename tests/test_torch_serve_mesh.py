"""Serving on a mesh (``ServeEngine(ctx=)``) on gloo ranks on the CPU,
against the JAX engine off a mesh.

The serving matrix of the reference's ``tests/test_serve.py``
(``test_serve_parity_matrix_8device``, ``..._fused_8device``) and
``tests/test_serve_prefix.py`` (``test_engine_prefix_parity_8device``)
on meshes (data, model) = (1, 2), (2, 1) and (2, 2), for both routing
policies: whole prompts, chunked prompts, the shared-prefix cache and
fused decode.  Each mesh is one spawn of ``torch_dist_workers.py``
(``case_serve``: every rank runs its own engine on the same trace, the
parameters sliced by the decode plan); the JAX engine runs here, off a
mesh, on the same parameters (a JAX-materialized tree with its gates
redrawn, moved across with ``from_jax_tree``).

Checked: every rank's greedy streams equal the JAX engine's; the
``prefills`` / ``prefill_chunks`` counters equal its counts and
``reshards`` equals the completed prompts (3 / 6 / 3 on the chunked
trace, the reference's mesh counts); the pool and a resharded page
hold ``max_len / model`` positions of ``kv_seq`` (the decode plan
shards the sequence over ``model``) and ``n_slots / data`` slots.  Then
``launch.serve`` under ``torch.distributed.run`` on two CPU ranks gives
one process's tokens.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_workers as workers

from repro.common import param as jpm
from repro.configs.base import get_config as jget_config
from repro.core.router import RouterSpec as JRouterSpec
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core.router import RouterSpec as TRouterSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
             vocab_size=64, n_experts=4, moe_k=2, moe_d_ff=32)
MESHES = [(1, 2), (2, 1), (2, 2)]
POLICIES = ["noisy_topk", "expert_choice"]
TRAFFIC = ["whole", "chunked", "prefix", "fused"]
MAX_LEN, N_SLOTS = 64, 4
CHUNK_KW = dict(prefill_chunk=16, prefill_budget=32, admission="aware")


def _traces():
    rs = np.random.RandomState(1)
    whole = [(rs.randint(1, 64, (n,)).astype(np.int32), m, a)
             for n, m, a in [(40, 4, 0), (8, 3, 0), (33, 5, 1), (12, 4, 2)]]
    chunked = [(rs.randint(1, 64, (n,)).astype(np.int32), m, a)
               for n, m, a in [(40, 4, 0), (8, 3, 1), (33, 4, 2)]]
    rs = np.random.RandomState(3)
    shared = rs.randint(1, 64, (32,)).astype(np.int32)
    prefix = [(np.concatenate([shared, rs.randint(1, 64, (8,))
                               .astype(np.int32)]), 4,
               0 if i == 0 else 12 + i) for i in range(4)]
    return {"whole": (whole, {}), "chunked": (chunked, CHUNK_KW),
            "prefix": (prefix, dict(CHUNK_KW, prefix_cache=True)),
            "fused": (whole, dict(fused_decode=True))}


def _jax_run(cfg, params, trace, kw):
    eng = jengine.ServeEngine(params, cfg, jengine.ServeConfig(
        max_len=MAX_LEN, n_slots=N_SLOTS, **kw))
    reqs = [eng.submit(p, m, arrival=a) for p, m, a in trace]
    eng.run()
    assert all(r.done for r in reqs)
    return {"streams": [list(r.tokens) for r in reqs],
            "stats": dict(eng.stats)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    traces = _traces()
    cases, want, waits = {}, {}, {}
    for policy in POLICIES:
        jcfg = jget_config("kimi-k2-1t-a32b").replace(
            param_dtype=jnp.float32, compute_dtype=jnp.float32,
            q_block=16, kv_block=16, kernel_backend="ref",
            router=JRouterSpec(policy=policy, capacity_factor=2.0), **SMALL)
        tcfg = tget_config("kimi-k2-1t-a32b", param_dtype=torch.float32,
                           compute_dtype=torch.float32, q_block=16,
                           kv_block=16,
                           router=TRouterSpec(policy=policy,
                                              capacity_factor=2.0), **SMALL)
        tree = jax.tree_util.tree_map(
            np.asarray, jpm.materialize(jlm.lm_defs(jcfg),
                                        jax.random.PRNGKey(0)))
        rs = np.random.RandomState(0)
        for layer in tree["blocks"]["periods"].values():
            gate = layer["moe"]["gate"]
            gate["wg"] = rs.randn(*gate["wg"].shape).astype(np.float32)
        tparams = from_jax_tree(tree, device="cpu")
        for traffic in TRAFFIC:
            trace, kw = traces[traffic]
            cases[f"{policy}-{traffic}"] = {
                "cfg": tcfg, "params": tparams, "trace": trace,
                "sc": dict(max_len=MAX_LEN, n_slots=N_SLOTS, **kw)}
        for traffic in ("whole", "chunked", "prefix"):
            trace, kw = traces[traffic]
            want[f"{policy}-{traffic}"] = _jax_run(jcfg, tree, trace, kw)
        # The JAX fused decode (ref backend) is its unfused path.
        want[f"{policy}-fused"] = want[f"{policy}-whole"]
    for data, model in MESHES:
        tmp = tmp_path_factory.mktemp(f"serve{data}x{model}")
        waits[(data, model)] = workers.start("serve", tmp, {"cases": cases},
                                             data, model, timeout=600)
    return {"ranks": {mesh: wait() for mesh, wait in waits.items()},
            "want": want}


@pytest.mark.parametrize("traffic", TRAFFIC)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x1", "2x2"])
def test_serve_on_mesh_matches_jax(run, mesh, policy, traffic):
    """Every rank's greedy streams are the JAX engine's off a mesh; the
    prefill counters are its counts, with one reshard per completed
    prompt."""
    name = f"{policy}-{traffic}"
    want = run["want"][name]
    for rank, out in enumerate(run["ranks"][mesh]):
        got = out[name]
        assert got["done"]
        assert got["streams"] == want["streams"], (rank, got["streams"],
                                                   want["streams"])
        for key in ("prefills", "prefill_chunks", "prefill_tokens",
                    "generated_tokens", "decode_steps", "prefix_hits"):
            assert got["stats"][key] == want["stats"][key], key
        assert got["stats"]["reshards"] == want["stats"]["prefills"]
    if traffic == "chunked":
        stats = run["ranks"][mesh][0][name]["stats"]
        assert (stats["prefills"], stats["prefill_chunks"],
                stats["reshards"]) == (3, 6, 3)
    if traffic == "prefix":
        assert run["ranks"][mesh][0][name]["stats"]["prefix_hits"] == 3


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x1", "2x2"])
def test_decode_pool_is_sequence_sharded(run, mesh):
    """The decode plan's layout: each rank's pool holds n_slots / data
    slots and max_len / model positions of every page, and a page
    resharded onto the plan holds max_len / model positions."""
    data, model = mesh
    for out in run["ranks"][mesh]:
        got = out["noisy_topk-whole"]
        # Cache leaves: [layers, slots, kv_seq, kv_heads, head_dim].
        assert got["pool_shape"][1:3] == (N_SLOTS // data, MAX_LEN // model)
        assert got["page_shape"][1:3] == (1, MAX_LEN // model)
        assert got["seq_axes"] == ("model",)
        assert got["slot_axes"] == ("data",)


def _launcher(extra: list) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.serve", "--device", "cpu", "--arch",
            "kimi-k2-1t-a32b", "--reduce", "--requests", "4", "--stagger",
            "1", "--new-tokens", "6"]
    proc = subprocess.run([sys.executable, *extra, *args], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_serve_launcher_on_two_ranks():
    """``launch.serve`` under ``torch.distributed.run`` on two CPU ranks
    (gloo, mesh (2, 1)) prints once and samples one process's tokens."""
    one = _launcher([])
    two = _launcher(["-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", "2"])
    assert "2 rank(s) over gloo, mesh {'data': 2, 'model': 1}" in two
    assert two.count("[serve] sample:") == 1
    sample = [line for line in one.splitlines() if "sample:" in line]
    assert sample and sample[0] in two
