"""Parameter trees across the two packages: the bridge round trip is byte
for byte (bf16 included), the port declares the same tree (keys, shapes,
dtypes) as the reference, and the port's ``materialize`` draws each leaf
in its own dtype with the reference's init scales."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import param as jpm
from repro.configs.base import count_params as jcount_params
from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.common import param as tpm
from repro_torch.common.bridge import from_jax_tree, to_jax_tree
from repro_torch.common.device import resolve_device
from repro_torch.configs.base import count_params as tcount_params
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import lm as tlm

SMALL = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             vocab_size=64, n_experts=4, moe_k=2, moe_d_ff=32)
_DT = {"bf16": (jnp.bfloat16, torch.bfloat16),
       "f32": (jnp.float32, torch.float32)}


def _cfgs(dt):
    jdt, tdt = _DT[dt]
    return (jget_config("kimi-k2-1t-a32b").replace(
                param_dtype=jdt, compute_dtype=jdt, **SMALL),
            tget_config("kimi-k2-1t-a32b", param_dtype=tdt,
                        compute_dtype=tdt, **SMALL))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("dt", sorted(_DT))
def test_round_trip_is_byte_equal(dt):
    jcfg, tcfg = _cfgs(dt)
    tree = jax.tree_util.tree_map(
        np.asarray, jpm.materialize(jlm.lm_defs(jcfg), jax.random.PRNGKey(0)))
    params = from_jax_tree(tree, device="cpu")
    back = _flat(to_jax_tree(params, bf16=np.dtype(jnp.bfloat16)))
    for path, leaf in _flat(tree).items():
        assert back[path].dtype == leaf.dtype, path
        assert back[path].tobytes() == leaf.tobytes(), path
    if dt == "bf16":
        w1 = params["blocks"]["periods"]["pos0"]["moe"]["w1"]
        assert w1.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            w1.float().numpy(),
            tree["blocks"]["periods"]["pos0"]["moe"]["w1"].astype(np.float32))


@pytest.mark.parametrize("dt", sorted(_DT))
def test_port_declares_the_reference_tree(dt):
    jcfg, tcfg = _cfgs(dt)
    jdefs = _flat(jlm.lm_defs(jcfg))
    tdefs = _flat(tlm.lm_defs(tcfg))
    assert sorted(jdefs) == sorted(tdefs)
    for path, jd in jdefs.items():
        td = tdefs[path]
        assert td.shape == jd.shape and td.axes == jd.axes, path
        assert td.init == jd.init and td.fan_in == jd.fan_in, path
        assert str(td.dtype).split(".")[-1] == jnp.dtype(jd.dtype).name
    assert tcount_params(tcfg) == jcount_params(jcfg)


def test_full_width_kimi_counts_match_reference():
    jcfg = jget_config("kimi-k2-1t-a32b", n_layers=2)
    tcfg = tget_config("kimi-k2-1t-a32b", n_layers=2)
    assert tcount_params(tcfg) == jcount_params(jcfg)
    assert tpm.param_bytes(tlm.lm_defs(tcfg)) == jpm.param_bytes(
        jlm.lm_defs(jcfg))


def test_materialize_draws_in_dtype_with_reference_scales():
    defs = {"w": tpm.ParamDef((3, 64, 256), ("experts", "a", "b"),
                              dtype=torch.bfloat16, fan_in=64),
            "e": tpm.ParamDef((128, 16), ("v", "d"), init="embed",
                              dtype=torch.float32),
            "z": tpm.ParamDef((5,), ("d",), init="zeros"),
            "o": tpm.ParamDef((5,), ("d",), init="ones", dtype=torch.float32),
            "u": tpm.ParamDef((400, 8), ("a", "b"), init="uniform_scale",
                              dtype=torch.float32)}
    p = tpm.materialize(defs, torch.Generator().manual_seed(0), "cpu")
    assert p["w"].dtype == torch.bfloat16 and p["w"].shape == (3, 64, 256)
    assert abs(float(p["w"].float().std()) - 1 / 8) < 0.01
    assert abs(float(p["e"].std()) - 1.0) < 0.1
    assert not p["z"].any() and bool((p["o"] == 1).all())
    assert float(p["u"].abs().max()) <= (3 / 400) ** 0.5
    again = tpm.materialize(defs, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["w"], again["w"])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        from_jax_tree({"a": np.zeros(2, np.float32)})
    assert resolve_device("cpu").type == "cpu"
