"""The port's sharding rules and MeshContext against the JAX package's.

For every plan of ``PLANS`` and every ParamDef of a small transformer
(``conftest.small_config``), a small MoE transformer and the paper LM,
the port's resolved specs and recorded fallbacks equal the reference's
``resolve_spec`` on meshes (1, 1), (2, 4) and (2, 16, 16).  The
reference reads only ``mesh.shape`` there, so a stand-in object with
that mapping serves, with no devices.  The rest needs no process group:
the plan tables, ``plan_for``, the null context, ``with_plan``,
``manual``, the contextvar and the identity constraint.
"""
import types

import jax
import pytest
import torch
from conftest import small_config
from test_torch_lm import _tcfg

from repro.models import lm as jlm
from repro.models import paper_lm as jpl
from repro.sharding import context as jctx
from repro.sharding import partition as jpart
from repro_torch.common.param import ParamDef, tree_leaves
from repro_torch.models import lm as tlm
from repro_torch.models import paper_lm as tpl
from repro_torch.sharding import context as tctx
from repro_torch.sharding import partition as tpart

MESHES = {"1x1": {"data": 1, "model": 1},
          "2x4": {"data": 2, "model": 4},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _as_spec(p) -> tuple:
    """A reference PartitionSpec as the port's tuple of axis tuples."""
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in p)


def _models():
    out = {}
    for arch in ("smollm-135m", "kimi-k2-1t-a32b"):
        jcfg = small_config(arch)
        out[arch] = (jlm.lm_defs(jcfg), tlm.lm_defs(_tcfg(jcfg)))
    kw = dict(vocab_size=96, d_model=32, n_experts=8, k=4, expert_hidden=48)
    out["paper-lm"] = (jpl.paper_lm_defs(jpl.PaperLMConfig(**kw)),
                       tpl.paper_lm_defs(tpl.PaperLMConfig(**kw)))
    return out


MODELS = _models()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("plan", sorted(jpart.PLANS))
def test_resolved_specs_and_fallbacks_match_reference(plan, mesh):
    sizes = MESHES[mesh]
    stand_in = types.SimpleNamespace(shape=sizes)
    for name, (jdefs, tdefs) in MODELS.items():
        jleaves = jax.tree_util.tree_leaves(
            jdefs, is_leaf=lambda d: hasattr(d, "axes"))
        tleaves = tree_leaves(tdefs)
        assert len(jleaves) == len(tleaves), name
        jfall, tfall, resolved = [], [], []
        for jd, td in zip(jleaves, tleaves):
            assert (tuple(jd.shape), tuple(jd.axes)) == (td.shape, td.axes)
            want = jpart.resolve_spec(jpart.PLANS[plan], stand_in, jd.shape,
                                      jd.axes, jfall)
            got = tpart.resolve_spec(tpart.PLANS[plan], sizes, td.shape,
                                     td.axes, tfall)
            assert got == _as_spec(want), (name, td)
            resolved.append(got)
        assert tfall == jfall, name
        specs = tpart.tree_pspecs(tpart.PLANS[plan], sizes, tdefs)
        assert tree_leaves(specs) == resolved, name


def test_plan_tables_and_plan_for_match_reference():
    assert sorted(tpart.PLANS) == sorted(jpart.PLANS)
    for name, rules in jpart.PLANS.items():
        assert dict(tpart.PLANS[name].table) == dict(rules.table), name
        assert tpart.PLANS[name].name == rules.name
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert tpart.plan_for(shape) == jpart.plan_for(shape)


def test_context_without_a_mesh():
    """The null context: no mesh, constraints the identity, shard and
    gather the tree itself; with_plan / manual / the contextvar as the
    reference's."""
    ctx = tctx.MeshContext.null()
    assert ctx.mesh is None and ctx.rules.name == "dp_tp_ep"
    assert not tctx.on_mesh(ctx) and not tctx.on_mesh(None)
    x = torch.ones(3, 4)
    assert ctx.with_constraint(x, ("batch", "embed")) is x
    tree = {"w": x}
    defs = {"w": ParamDef((3, 4), ("embed_fsdp", "mlp"))}
    assert ctx.shard(tree, defs) is tree and ctx.gather(tree, defs) is tree
    assert ctx.with_plan("dp_only").rules is tpart.PLANS["dp_only"]
    m = ctx.manual("model").manual("pod")
    assert m.manual_axes == frozenset({"model", "pod"})
    assert tctx.current_ctx() is None
    with ctx:
        assert tctx.current_ctx() is ctx
        with m:
            assert tctx.current_ctx() is m
        assert tctx.current_ctx() is ctx
    assert tctx.current_ctx() is None
    with pytest.raises(RuntimeError, match="concrete mesh"):
        ctx.resolve((8, 8), ("embed_fsdp", "mlp"))


def test_manual_axes_are_stripped_as_in_the_reference():
    sizes = {"data": 2, "model": 4}
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 shape=tuple(sizes.values()))
    ctx = tctx.MeshContext.for_mesh(mesh, "dp_tp_ep").manual("model")
    jmesh = types.SimpleNamespace(shape=sizes)
    jc = jctx.MeshContext(mesh=jmesh, rules=jpart.PLANS["dp_tp_ep"],
                          manual_axes=frozenset({"model"}))
    for shape, axes in [((8, 16), ("embed_fsdp", "mlp")),
                        ((8, 16, 32), ("experts", "expert_embed",
                                       "expert_mlp")),
                        ((16, 8), ("tokens", "embed"))]:
        assert ctx.resolve(shape, axes) == _as_spec(jc.resolve(shape, axes))


def _serving_and_pipeline_defs():
    """Decode caches (batch, kv_seq) of a small kimi-k2 family model, one
    page and a pool of 4 slots, and its pipeline blocks on 2 stages
    (stage, layers): the reference's defs and the port's."""
    from repro.models import transformer as jtr
    from repro.train import pipeline as jpp
    from repro_torch.models import transformer as ttr
    from repro_torch.train import pipeline as tpp
    jcfg = small_config("kimi-k2-1t-a32b")
    tcfg = _tcfg(jcfg)
    return {"page": (jtr.cache_defs(jcfg, 1, 64), ttr.cache_defs(tcfg, 1, 64)),
            "pool": (jtr.cache_defs(jcfg, 4, 64), ttr.cache_defs(tcfg, 4, 64)),
            "pipeline": (jpp.pipeline_param_defs(jcfg, 2),
                         tpp.pipeline_param_defs(tcfg, 2))}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("plan", ["prefill_tp", "decode_std", "dp_tp_ep"])
def test_cache_and_pipeline_specs_match_reference(plan, mesh):
    """The serving plans' specs of the decode caches (``decode_std`` puts
    the batch over data and ``kv_seq`` over model; a page of one row
    falls back to a replicated batch) and every plan's specs of the
    pipeline's stacked blocks (``stage`` and ``layers`` map to no mesh
    axis), with their fallbacks, equal the reference's."""
    sizes = MESHES[mesh]
    stand_in = types.SimpleNamespace(shape=sizes)
    for name, (jdefs, tdefs) in _serving_and_pipeline_defs().items():
        jleaves = jax.tree_util.tree_leaves(
            jdefs, is_leaf=lambda d: hasattr(d, "axes"))
        tleaves = tree_leaves(tdefs)
        assert len(jleaves) == len(tleaves), name
        jfall, tfall = [], []
        for jd, td in zip(jleaves, tleaves):
            assert (tuple(jd.shape), tuple(jd.axes)) == (td.shape, td.axes)
            want = jpart.resolve_spec(jpart.PLANS[plan], stand_in, jd.shape,
                                      jd.axes, jfall)
            got = tpart.resolve_spec(tpart.PLANS[plan], sizes, td.shape,
                                     td.axes, tfall)
            assert got == _as_spec(want), (name, td)
            if "stage" in td.axes:
                assert got[:2] == ((), ())
            if plan == "decode_std" and name == "pool" and mesh == "2x4":
                assert got[1:3] == (("data",), ("model",))
        assert tfall == jfall, name


def test_pipeline_context_and_manual_world():
    """The pipeline's own plan puts the stacked blocks' stage dim over the
    stage axis (so the other dims cannot take it); a body manual over an
    axis counts ranks, coordinates and default collectives over the
    other axes only."""
    from repro_torch.train import pipeline as tpp
    sizes = {"data": 2, "model": 4}
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 shape=tuple(sizes.values()))
    ctx = tctx.MeshContext.for_mesh(mesh, "dp_tp_ep")
    pp = tpp.pipeline_context(ctx)
    assert ctx.resolve((2, 3, 8, 16), ("stage", "layers", "embed_fsdp",
                                       "mlp")) == ((), (), ("data",),
                                                   ("model",))
    assert pp.resolve((2, 3, 8, 16), ("stage", "layers", "embed_fsdp",
                                      "mlp")) == (("data",), (), (),
                                                  ("model",))
    body = pp.manual("data")
    assert body.resolve((2, 3, 8, 16), ("stage", "layers", "embed_fsdp",
                                        "mlp")) == ((), (), (), ("model",))
    assert ctx.world == 8 and body.world == 4
    assert body.free_axes == ("model",) and body.axes_of("batch") == ()
    assert ctx.axes_of("batch") == ("data",)
