"""Serving mamba mixers and sliding-window attention on a mesh
(``ServeEngine(ctx=)``, ``lm_prefill`` / ``lm_decode(ctx=)``) on gloo
CPU ranks, against the JAX package's one process.

The reference serves falcon-mamba, gemma3 and jamba under GSPMD: its
mesh run is its one-process run, so the ranks are held to JAX's engine
and to its ``lm_prefill`` / ``lm_decode`` off a mesh, at
``tests/conftest.py::small_config`` scale.  One spawn of
``torch_dist_workers.py`` (``case_routed``: its serving and logits
cases) a mesh, the three run concurrently while the JAX side runs here:

* (2, 1) and (1, 2): falcon-mamba (the scan and conv state whole, the
  slots over ``data``);
* (1, 2): gemma3 with prompts longer than its 32-token window (the ring
  wraps, split 16 slots a rank), and with a 33-token window, whose ring
  does not divide over ``model`` and stays whole while the global
  layer's page splits;
* (2, 2): jamba, unfused and fused decode (its MoE experts over
  ``model``).

Checked: every rank's greedy streams and prefill counters are the JAX
engine's; a whole prefill on every rank and one decode step of each
rank's slots give JAX's logits (rtol 2e-4 / atol 2e-5, the reference's
expert-parallel tolerance, ``tests/test_distributed.py``); each pool
leaf a rank holds has ``n_slots / data`` slots, ``max_len / model``
positions of a global page, ``L / model`` ring slots where the ring
divides (else all ``L``), and the whole state (``d_inner`` channels).
jamba's and gemma3's first pool leaf is a mamba state or a ring, so a
plan fitted to the first leaf alone would leave the pages whole.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_workers as workers
from conftest import small_config
from test_torch_lm import _params as lm_params
from test_torch_lm import _tcfg

from repro.common import param as jpm
from repro.models import lm as jlm
from repro.models import transformer as jtransformer
from repro.serve import engine as jengine
from repro_torch.common import param as tpm
from repro_torch.common.bridge import from_jax_tree
from repro_torch.models import transformer as ttransformer

TOL = dict(rtol=2e-4, atol=2e-5)
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
# (arch, small_config overrides, max_len, slots): the models served.
# gemma3 and jamba keep one stacked period and a tail layer.
MODELS = {
    "falcon": ("falcon-mamba-7b", {}, 72, 4),
    "gemma": ("gemma3-27b", {"n_layers": 7}, 80, 2),
    "gemma_odd": ("gemma3-27b", {"n_layers": 7, "sliding_window": 33}, 80,
                  2),
    "jamba": ("jamba-v0.1-52b", {"n_layers": 9}, 72, 4),
}
# (prompt length, new tokens, arrival step), more requests than slots,
# two prompt lengths a trace (the JAX engine compiles a prefill for
# each).  A mamba prompt is shorter than the 128-token scan chunk, and
# no shorter than d_conv - 1 (ROADMAP C.4); the reference's whole-prompt
# attention needs a length its 32-token blocks divide, or one shorter
# than a block.  gemma3's 64-token prompts and its 8-token prompt's 30
# new tokens wrap its ring.
TRACES = {
    "falcon": [(9, 6, 0), (64, 4, 0), (9, 5, 1), (64, 3, 2), (9, 5, 3)],
    "gemma": [(8, 30, 0), (64, 12, 0), (8, 20, 1), (64, 6, 3)],
}
TRACES.update(gemma_odd=TRACES["gemma"], jamba=TRACES["falcon"])
# (model, ServeConfig fields) of each case, a mesh.
SERVE = {
    "2x1": {"falcon": ("falcon", {})},
    "1x2": {"falcon": ("falcon", {}), "gemma": ("gemma", {}),
            "gemma_odd": ("gemma_odd", {})},
    "2x2": {"jamba": ("jamba", {}),
            "jamba_fused": ("jamba", {"fused_decode": True})},
}
# The logits cases a mesh: (model, prompt rows x length).
LOGITS = {"2x1": {"falcon": 16}, "1x2": {"falcon": 16, "gemma": 64},
          "2x2": {"jamba": 16}}


def _jcfg(name):
    arch, kw, _, _ = MODELS[name]
    return small_config(arch, kernel_backend="ref", **kw)


def _jax_engine(jcfg, tree, trace, max_len, slots):
    eng = jengine.ServeEngine(tree, jcfg, jengine.ServeConfig(
        max_len=max_len, n_slots=slots))
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
    models, inputs, logit_rows = {}, {}, {}
    rs = np.random.RandomState(7)
    for name in MODELS:
        jcfg = _jcfg(name)
        tree = lm_params(jcfg, seed=3)
        trace = [(rs.randint(1, jcfg.vocab_size, (n,)).astype(np.int32), m,
                  a) for n, m, a in TRACES[name]]
        models[name] = (jcfg, tree, from_jax_tree(tree, device="cpu"),
                        trace)
    for mesh in MESHES:
        serve, logits = {}, {}
        for case, (name, kw) in SERVE[mesh].items():
            jcfg, _, tparams, trace = models[name]
            _, _, max_len, slots = MODELS[name]
            serve[case] = {"cfg": _tcfg(jcfg), "params": tparams,
                           "trace": trace,
                           "sc": dict(max_len=max_len, n_slots=slots, **kw)}
        for name, s in LOGITS[mesh].items():
            jcfg, _, tparams, _ = models[name]
            tokens = rs.randint(1, jcfg.vocab_size, (4, s)).astype(np.int32)
            nxt = rs.randint(1, jcfg.vocab_size, (4,)).astype(np.int32)
            logit_rows[(mesh, name)] = (tokens, nxt, s + 8)
            logits[name] = {"cfg": _tcfg(jcfg), "params": tparams,
                            "tokens": torch.from_numpy(tokens),
                            "next": torch.from_numpy(nxt), "max_len": s + 8}
        inputs[mesh] = {"serve": serve, "logits": logits}
    waits = {mesh: workers.start("routed", tmp_path_factory.mktemp(mesh),
                                 inputs[mesh], *MESHES[mesh], timeout=300)
             for mesh in MESHES}
    want_serve = {}
    for name, (jcfg, tree, _, trace) in models.items():
        _, _, max_len, slots = MODELS[name]
        # The JAX fused decode (ref backend) is its unfused path.
        want_serve[name] = _jax_engine(jcfg, tree, trace, max_len, slots)
    want_logits = {key: _jax_logits(models[key[1]][0], models[key[1]][1],
                                    *rows)
                   for key, rows in logit_rows.items()}
    return {"ranks": {mesh: wait() for mesh, wait in waits.items()},
            "serve": want_serve, "logits": want_logits}


SERVE_IDS = [(mesh, case) for mesh in MESHES for case in SERVE[mesh]]


@pytest.mark.parametrize("mesh,case", SERVE_IDS,
                         ids=[f"{c}-{m}" for m, c in SERVE_IDS])
def test_served_on_mesh_matches_jax(run, mesh, case):
    """Every rank's greedy streams and prefill counters are the JAX
    engine's off a mesh, with one reshard a completed prompt."""
    want = run["serve"][SERVE[mesh][case][0]]
    for out in run["ranks"][mesh]:
        got = out["serve"][case]
        assert got["done"]
        assert got["streams"] == want["streams"], (got["streams"],
                                                   want["streams"])
        for key in ("prefills", "prefill_tokens", "generated_tokens",
                    "decode_steps"):
            assert got["stats"][key] == want["stats"][key], key
        assert got["stats"]["reshards"] == want["stats"]["prefills"]


LOGIT_IDS = [(mesh, name) for mesh in MESHES for name in LOGITS[mesh]]


@pytest.mark.parametrize("mesh,name", LOGIT_IDS,
                         ids=[f"{n}-{m}" for m, n in LOGIT_IDS])
def test_logits_on_mesh_match_jax(run, mesh, name):
    """lm_prefill's logits (whole rows on every rank) and one lm_decode
    step's (each rank's slots, the page relaid onto the decode plan
    fitted to the cache)."""
    want = run["logits"][(mesh, name)]
    data, model = MESHES[mesh]
    n = 4 // data
    for rank, out in enumerate(run["ranks"][mesh]):
        got = out["logits"][name]
        np.testing.assert_allclose(got["prefill"].numpy(), want["prefill"],
                                   **TOL)
        d = rank // model
        np.testing.assert_allclose(got["decode"].numpy(),
                                   want["decode"][d * n:(d + 1) * n], **TOL)


def _want_local(defs, data, model):
    """Each pool leaf's local shape: the slots over data, a page's
    positions (a ring's slots where they divide) over model, the rest
    whole."""
    out = []
    for d in tpm.tree_leaves(defs):
        shape = list(d.shape)
        shape[d.axes.index("batch")] //= data
        seq = [i for i, a in enumerate(d.axes) if a in ("kv_seq", "kv_ring")]
        if seq:
            i = seq[0]
            if shape[i] % model == 0:
                shape[i] //= model
        out.append(tuple(shape))
    return out


@pytest.mark.parametrize("mesh,case", SERVE_IDS,
                         ids=[f"{c}-{m}" for m, c in SERVE_IDS])
def test_pool_layout_on_mesh(run, mesh, case):
    """The pool each rank holds: n_slots / data slots of every leaf,
    max_len / model positions of a global page, L / model slots of a
    ring that divides (all L of gemma3's 33-slot ring), and the mamba
    scan and conv states whole (d_inner channels)."""
    name = SERVE[mesh][case][0]
    _, _, max_len, slots = MODELS[name]
    cfg = _tcfg(_jcfg(name))
    data, model = MESHES[mesh]
    defs = ttransformer.cache_defs(cfg, slots, max_len)
    want = _want_local(defs, data, model)
    leaves = tpm.tree_leaves(defs)
    kinds = {tuple(d.axes) for d in leaves}
    if name != "falcon":
        # A page that splits, beside a leaf that does not.
        assert any(w != tuple(d.shape) and "kv_seq" in d.axes
                   for w, d in zip(want, leaves))
    if name == "gemma_odd":
        assert any("kv_ring" in d.axes and w[2] == 33
                   for w, d in zip(want, leaves))
    if name in ("falcon", "jamba"):
        d_in = cfg.ssm_expand * cfg.d_model
        assert any("ssm_inner" in a for a in kinds)
        assert all(w[d.axes.index("ssm_inner")] == d_in
                   for w, d in zip(want, leaves) if "ssm_inner" in d.axes)
    for out in run["ranks"][mesh]:
        assert out["serve"][case]["pool_shapes"] == want
