"""The flat MoE's experts served tensor-parallel over ``data``: the
reference's ``expert_mlp`` in its serving plans (``prefill_tp``,
``decode_std``, ``decode_long``).

``expert_parallel.serve_layout`` keeps each rank's block of the flat
MoE's FFN leaves over ``experts`` (``model``) and ``expert_mlp``
(``data``); ``moe_apply_serve`` runs the d_ff slice, sums its f32
partial outputs over ``data`` and casts once (fused decode: kernel 8's
f32 partial sums, all-reduced over both axes).  The reference serves
under GSPMD, so its mesh run is its one process: the ranks are held to
the JAX engine and to JAX's ``lm_prefill`` / ``lm_decode`` off a mesh.
One spawn of ``torch_dist_workers.py`` (``case_expert_tp``) a mesh,
(2, 1) and (2, 2), run concurrently while the JAX side runs here:

* each rank's ``w1`` / ``w3`` are ``[E/model, d, f/data]`` and its
  ``w2`` ``[E/model, f/data, d]``, the whole tree's block at the rank's
  coordinates; the layout passed in again is kept, and the whole tree
  passed in gives the same layout;
* the engine (reduced kimi-k2, f32), unfused and fused decode, noisy
  top-k and expert choice: every rank's greedy streams and prefill
  counters are the JAX engine's, served from d_ff slices;
* a whole prefill on every rank and one decode step of each rank's
  slots (unfused and fused) give JAX's logits within rtol 2e-4 / atol
  2e-5, the reference's expert-parallel tolerance (a sum split over d_ff
  rounds otherwise than one product).

On one process: kernel 6's f32 output (``gmm(out_dtype=)``), its plain
version against the f32 product, two d_ff halves' partial sums against
the whole expert FFN, the refusals and the meta branch.  Under fake
process groups: a decode cell's expert bytes a rank are 1 / (model x
data) of the whole.
"""
import json
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
from repro.models import transformer as jtransformer
from repro.serve import engine as jengine
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core.router import RouterSpec as TRouterSpec
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import gmm as gmm_lib
from repro_torch.kernels import ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-5)
# The reduced kimi-k2 of tests/test_torch_serve_mesh.py: 4 experts of
# d_ff 32, so (2, 2) holds 2 experts of 16 columns a rank.
SMALL = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
             vocab_size=64, n_experts=4, moe_k=2, moe_d_ff=32)
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}
POLICIES = ["noisy_topk", "expert_choice"]
MODES = {"unfused": {}, "fused": {"fused_decode": True}}
MAX_LEN, N_SLOTS = 64, 4


def _configs(policy: str):
    jcfg = jget_config("kimi-k2-1t-a32b").replace(
        param_dtype=jnp.float32, compute_dtype=jnp.float32, q_block=16,
        kv_block=16, kernel_backend="ref",
        router=JRouterSpec(policy=policy, capacity_factor=2.0), **SMALL)
    tcfg = tget_config("kimi-k2-1t-a32b", param_dtype=torch.float32,
                       compute_dtype=torch.float32, q_block=16, kv_block=16,
                       router=TRouterSpec(policy=policy,
                                          capacity_factor=2.0), **SMALL)
    return jcfg, tcfg


def _tree(jcfg):
    """A JAX-materialized tree with its gates redrawn (the zero gate
    routes every token to experts 0..k-1)."""
    tree = jax.tree_util.tree_map(
        np.asarray, jpm.materialize(jlm.lm_defs(jcfg),
                                    jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    for layer in tree["blocks"]["periods"].values():
        gate = layer["moe"]["gate"]
        gate["wg"] = rs.randn(*gate["wg"].shape).astype(np.float32)
    return tree


def _trace():
    rs = np.random.RandomState(1)
    return [(rs.randint(1, 64, (n,)).astype(np.int32), m, a)
            for n, m, a in [(40, 4, 0), (8, 3, 0), (33, 5, 1), (12, 4, 2)]]


def _jax_engine(jcfg, tree, trace):
    eng = jengine.ServeEngine(tree, jcfg, jengine.ServeConfig(
        max_len=MAX_LEN, n_slots=N_SLOTS))
    reqs = [eng.submit(p, m, arrival=a) for p, m, a in trace]
    eng.run()
    assert all(r.done for r in reqs)
    return {"streams": [list(r.tokens) for r in reqs],
            "stats": dict(eng.stats)}


def _jax_logits(jcfg, tree, tokens, nxt, max_len):
    """JAX's lm_prefill of the rows from a zero cache, then one
    lm_decode step of the tokens ``nxt``."""
    b, s = tokens.shape
    cache = jpm.materialize(jtransformer.cache_defs(jcfg, b, max_len),
                            jax.random.PRNGKey(0))
    pre, cache = jlm.lm_prefill(tree, {"tokens": jnp.asarray(tokens)},
                                cache, jcfg)
    step, _ = jlm.lm_decode(tree, jnp.asarray(nxt), cache, s, jcfg)
    return {"prefill": np.asarray(pre), "decode": np.asarray(step)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks start first; the JAX side runs while they serve."""
    trace = _trace()
    rs = np.random.RandomState(7)
    tokens = rs.randint(1, 64, (4, 16)).astype(np.int32)
    nxt = rs.randint(1, 64, (4,)).astype(np.int32)
    inputs = {"layout": {}, "serve": {}, "logits": {}}
    models = {}
    for policy in POLICIES:
        jcfg, tcfg = _configs(policy)
        tree = _tree(jcfg)
        tparams = from_jax_tree(tree, device="cpu")
        models[policy] = (jcfg, tree)
        inputs["layout"][policy] = {"cfg": tcfg, "params": tparams}
        for mode, kw in MODES.items():
            inputs["serve"][f"{policy}-{mode}"] = {
                "cfg": tcfg, "params": tparams, "trace": trace,
                "sc": dict(max_len=MAX_LEN, n_slots=N_SLOTS, **kw)}
            inputs["logits"][f"{policy}-{mode}"] = {
                "cfg": tcfg.replace(**kw), "params": tparams,
                "tokens": torch.from_numpy(tokens),
                "next": torch.from_numpy(nxt), "max_len": 24}
    waits = {mesh: workers.start("expert_tp", tmp_path_factory.mktemp(mesh),
                                 inputs, *MESHES[mesh], timeout=300)
             for mesh in MESHES}
    # The JAX fused decode (ref backend) is its unfused path.
    want_serve = {p: _jax_engine(jcfg, tree, trace)
                  for p, (jcfg, tree) in models.items()}
    want_logits = {p: _jax_logits(jcfg, tree, tokens, nxt, 24)
                   for p, (jcfg, tree) in models.items()}
    return {"ranks": {mesh: wait() for mesh, wait in waits.items()},
            "params": {p: inputs["layout"][p]["params"] for p in POLICIES},
            "serve": want_serve, "logits": want_logits}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", MESHES)
def test_serve_layout_is_the_block_over_experts_and_d_ff(run, mesh,
                                                         policy):
    data, model = MESHES[mesh]
    e, f = SMALL["n_experts"] // model, SMALL["moe_d_ff"] // data
    d = SMALL["d_model"]
    whole = run["params"][policy]["blocks"]["periods"]["pos0"]["moe"]
    for out in run["ranks"][mesh]:
        got = out["layout"][policy]
        assert got["kept"] and got["from_whole"]
        i, j = out["coords"]["model"], out["coords"]["data"]
        experts, cols = slice(i * e, (i + 1) * e), slice(j * f, (j + 1) * f)
        for k in ("w1", "w3"):
            assert tuple(got["leaves"][k].shape) == (e, d, f)
            assert torch.equal(got["leaves"][k],
                               whole[k][0][experts][..., cols])
        assert tuple(got["leaves"]["w2"].shape) == (e, f, d)
        assert torch.equal(got["leaves"]["w2"],
                           whole["w2"][0][experts][:, cols])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", MESHES)
def test_engine_on_d_ff_slices_matches_jax(run, mesh, policy, mode):
    """Every rank's greedy streams and prefill counters are the JAX
    engine's off a mesh, served from the rank's d_ff slices."""
    data, model = MESHES[mesh]
    want = run["serve"][policy]
    e, f = SMALL["n_experts"] // model, SMALL["moe_d_ff"] // data
    for out in run["ranks"][mesh]:
        got = out["serve"][f"{policy}-{mode}"]
        assert got["done"]
        assert got["expert_shapes"]["w1"] == (e, SMALL["d_model"], f)
        assert got["expert_shapes"]["w2"] == (e, f, SMALL["d_model"])
        assert got["streams"] == want["streams"], (got["streams"],
                                                   want["streams"])
        for key in ("prefills", "prefill_tokens", "generated_tokens",
                    "decode_steps"):
            assert got["stats"][key] == want["stats"][key], key
        assert got["stats"]["reshards"] == want["stats"]["prefills"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", MESHES)
def test_logits_on_d_ff_slices_match_jax(run, mesh, policy, mode):
    """lm_prefill's logits (whole rows on every rank) and one lm_decode
    step's (each rank's slots)."""
    want = run["logits"][policy]
    data, model = MESHES[mesh]
    n = 4 // data
    for rank, out in enumerate(run["ranks"][mesh]):
        got = out["logits"][f"{policy}-{mode}"]
        np.testing.assert_allclose(got["prefill"].numpy(), want["prefill"],
                                   **TOL)
        j = rank // model
        np.testing.assert_allclose(got["decode"].numpy(),
                                   want["decode"][j * n:(j + 1) * n], **TOL)


# ---------------------------------------------------------------------------
# kernel 6's f32 output, on one process
# ---------------------------------------------------------------------------

def _bf16(gen, *shape, scale=1.0):
    return (scale * torch.randn(shape, generator=gen)).to(torch.bfloat16)


@pytest.mark.parametrize("activation", ["none", "relu", "silu"])
def test_gmm_f32_output_is_the_f32_product(activation):
    """The plain version's f32 output is the epilogue of the f32
    product, with no cast; rows past ``rows[e]`` are zeros."""
    gen = torch.Generator().manual_seed(0)
    x, w = _bf16(gen, 3, 8, 64), _bf16(gen, 3, 64, 40, scale=0.125)
    rows = torch.tensor([8, 3, 0], dtype=torch.int32)
    got = gmm_lib.gmm(x, w, activation=activation, rows=rows,
                      out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = gmm_lib.activate(torch.bmm(x.float(), w.float()), activation)
    want = gmm_lib.mask_rows(want, rows)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    cast = gmm_lib.gmm(x, w, activation=activation, rows=rows)
    assert cast.dtype == torch.bfloat16
    assert torch.equal(cast, got.to(torch.bfloat16))


def test_d_ff_halves_sum_to_the_whole_expert_ffn():
    """swiglu over bf16 operands: the two halves' f32 partial outputs
    summed are the whole expert FFN's f32 output within 1e-6 of its
    scale (the gate product is elementwise in d_ff; only the
    down-projection's sum is split)."""
    gen = torch.Generator().manual_seed(1)
    e, c, d, f = 4, 8, 64, 96
    x = _bf16(gen, e, c, d)
    p = {"w1": _bf16(gen, e, d, f, scale=d ** -0.5),
         "w3": _bf16(gen, e, d, f, scale=d ** -0.5),
         "w2": _bf16(gen, e, f, d, scale=f ** -0.5)}
    rows = torch.tensor([8, 5, 1, 0], dtype=torch.int32)
    whole = ops.expert_ffn(p, x, activation="swiglu", rows=rows,
                           out_dtype=torch.float32)
    halves = []
    for cols in (slice(0, f // 2), slice(f // 2, f)):
        part = {"w1": p["w1"][..., cols].contiguous(),
                "w3": p["w3"][..., cols].contiguous(),
                "w2": p["w2"][:, cols].contiguous()}
        halves.append(ops.expert_ffn(part, x, activation="swiglu",
                                     rows=rows, out_dtype=torch.float32))
    assert whole.dtype == halves[0].dtype == torch.float32
    scale = float(whole.abs().max())
    assert scale > 0
    assert float((halves[0] + halves[1] - whole).abs().max()) <= 1e-6 * scale
    # The default output is the bf16 cast of the same accumulator.
    assert torch.equal(ops.expert_ffn(p, x, activation="swiglu", rows=rows),
                       whole.to(torch.bfloat16))


def test_gmm_f32_output_refusals_and_meta_branch():
    x = torch.zeros((2, 8, 16), dtype=torch.bfloat16)
    w = torch.zeros((2, 16, 24), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="out_dtype"):
        gmm_lib.gmm(x, w.transpose(1, 2).contiguous(), trans_w=True,
                    out_dtype=torch.float32)
    with pytest.raises(ValueError, match="out_dtype"):
        gmm_lib.gmm(x.float(), w.float(), out_dtype=torch.bfloat16)
    with cuda_lib.meta_trace():
        for kernel in ("stream", "tile"):
            out = gmm_lib.gmm(x.to("meta"), w.to("meta"), kernel=kernel,
                              out_dtype=torch.float32)
            assert out.device.type == "meta"
            assert (tuple(out.shape), out.dtype) == ((2, 8, 24),
                                                     torch.float32)


# ---------------------------------------------------------------------------
# a decode cell under fake process groups
# ---------------------------------------------------------------------------

_CELL = """
import json
from repro_torch.common.param import tree_leaves
from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_step
from repro_torch.launch.train import reduced
from repro_torch.models import lm
cfg = reduced(get_config("kimi-k2-1t-a32b")).replace(kernel_backend="ref")
out = {}
for fused in (False, True):
    spec = build_step(cfg.replace(fused_decode=fused),
                      ShapeSpec("decode", "decode", 64, 8),
                      dryrun.fake_mesh({"data": 2, "model": 2}))
    params = spec.args[0]
    moe = [p["moe"] for p in params["blocks"]["periods"].values()]
    held = sum(t.numel() * t.element_size() for m in moe
               for k, t in m.items() if k in ("w1", "w2", "w3"))
    defs = lm.lm_defs(cfg)["blocks"]["periods"].values()
    whole = sum(d.size * d.dtype.itemsize for m in defs
                for k, d in m["moe"].items() if k in ("w1", "w2", "w3"))
    rec = dryrun.trace_step(spec, flops=False)
    out[f"fused={fused}"] = {
        "held": held, "whole": whole,
        "shapes": {k: list(moe[0][k].shape) for k in ("w1", "w2")},
        "peak": rec["memory"]["peak_bytes_per_device"],
        "parameters": rec["memory"]["parameters"],
        "all_reduce": rec["collectives"].get("all_reduce", {}).get("calls", 0),
        "held_all": sum(t.numel() * t.element_size()
                        for t in tree_leaves(params))}
print(json.dumps(out))
"""


def test_decode_cell_holds_a_rank_block_of_the_experts():
    """The reduced kimi-k2's (8 experts, d_ff 64) decode step on a fake
    (2, 2) group: each rank's expert leaves are [L, 4, 64, 32] / [L, 4,
    32, 64], a quarter of the whole tree's expert bytes; the step
    traces, holding them among its parameters, and all-reduces (the
    partial sums)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _CELL], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout)
    for fused in (False, True):
        got = out[f"fused={fused}"]
        assert got["held"] * 4 == got["whole"] > 0
        assert got["shapes"]["w1"][1:] == [4, 64, 32]
        assert got["shapes"]["w2"][1:] == [4, 32, 64]
        assert got["parameters"] >= got["held_all"] > got["held"]
        assert got["peak"] >= got["parameters"]
        assert got["all_reduce"] > 0
