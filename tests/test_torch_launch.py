"""The port's launchers on the CPU: ``launch.train`` trains, writes its
metrics and checkpoints, resumes, and refuses the two reference flags
that have no counterpart (``--trace`` is tested in test_torch_obs.py);
``launch.serve --ckpt`` serves what it trained; a dense model serves the
JAX engine's greedy streams."""
import json
import os

import jax
import numpy as np
import pytest
from conftest import small_config
from test_torch_lm import _tcfg

from repro.common import param as jpm
from repro.configs.base import get_config as jget_config
from repro.launch.train import reduced as jreduced
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.train import checkpoint as jckpt
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.serve import engine as tengine

TRAIN = ["--reduce", "--device", "cpu", "--batch", "4", "--seq", "32"]


def test_train_launcher_runs_writes_metrics_and_resumes(tmp_path, capsys):
    work = str(tmp_path / "w")
    final = tlaunch.main(["--arch", "kimi-k2-1t-a32b", *TRAIN, "--steps", "6",
                          "--checkpoint-every", "3", "--workdir", work])
    assert final["step"] == 6 and np.isfinite(final["loss"])
    assert final["aux_loss"] > 0                  # the MoE layers trained
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows[-1]["step"] == 6
    assert sorted(os.listdir(os.path.join(work, "ckpt")))[-1] == \
        "step_0000000006"
    again = tlaunch.main(["--arch", "kimi-k2-1t-a32b", *TRAIN, "--steps", "6",
                          "--workdir", work])
    assert again == {}
    assert "restored checkpoint at step 6" in capsys.readouterr().out


@pytest.mark.parametrize("flags,why", [
    (["--dispatch-vmem-limit", "1048576"], "no VMEM budget"),
    (["--no-gmm-autotune"], "no GMM tuning table")])
def test_train_launcher_refuses_unported_flags(tmp_path, flags, why):
    with pytest.raises(NotImplementedError, match=why):
        tlaunch.main(["--arch", "moa-demo", *TRAIN, "--steps", "1",
                      "--workdir", str(tmp_path), *flags])


def test_reduced_is_the_references():
    for arch in ("kimi-k2-1t-a32b", "smollm-135m", "moa-demo"):
        want = jreduced(jget_config(arch))
        got = tlaunch.reduced(get_config(arch))
        for f in ("n_layers", "d_model", "vocab_size", "n_heads",
                  "n_kv_heads", "head_dim", "d_ff", "n_experts", "moe_k",
                  "moe_d_ff", "q_block", "kv_block"):
            assert getattr(got, f) == getattr(want, f), (arch, f)


def _launcher_requests(vocab, n, prompt_len, seed=0):
    """The prompts ``launch.serve`` draws for ``--requests n``."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, vocab, (0,))
    return [np.concatenate([shared, rng.randint(1, vocab, (prompt_len,))])
            for _ in range(n)]


def test_serve_ckpt_serves_what_train_trained(tmp_path):
    """``launch.serve --ckpt`` on ``launch.train``'s checkpoint gives the
    greedy tokens of an engine handed the same parameters directly (read
    with the JAX package's CheckpointManager), and the JAX engine's."""
    work = str(tmp_path / "w")
    tlaunch.main(["--arch", "smollm-135m", *TRAIN, "--steps", "3",
                  "--workdir", work])
    n, plen, new = 3, 8, 4
    got = tserve.main(["--arch", "smollm-135m", "--reduce", "--device", "cpu",
                       "--ckpt", os.path.join(work, "ckpt"), "--requests",
                       str(n), "--prompt-len", str(plen), "--new-tokens",
                       str(new)])
    jcfg = jreduced(jget_config("smollm-135m"))
    like = {"params": jpm.materialize(jlm.lm_defs(jcfg),
                                      jax.random.PRNGKey(0))}
    mgr = jckpt.CheckpointManager(os.path.join(work, "ckpt"))
    tree = jax.tree_util.tree_map(
        np.asarray, mgr.restore(mgr.latest_step(), like)[0]["params"])
    prompts = _launcher_requests(jcfg.vocab_size, n, plen)
    kw = dict(max_len=plen + new + 1, n_slots=n)
    teng = tengine.ServeEngine(from_jax_tree(tree, device="cpu"),
                               tlaunch.reduced(get_config("smollm-135m")),
                               tengine.ServeConfig(**kw), device="cpu")
    jeng = jengine.ServeEngine(tree, jcfg, jengine.ServeConfig(**kw))
    streams = []
    for eng in (teng, jeng):
        reqs = [eng.submit(p, new) for p in prompts]
        eng.run()
        streams.append([list(r.tokens) for r in reqs])
    assert got == streams[0] == streams[1]


def test_dense_model_serves_the_jax_engines_streams():
    """smollm-135m's small_config (no MoE: no telemetry) through the
    port's engine and the JAX engine: the same greedy streams and
    stats."""
    jcfg = small_config("smollm-135m")
    tree = jax.tree_util.tree_map(
        np.asarray, jpm.materialize(jlm.lm_defs(jcfg), jax.random.PRNGKey(0)))
    rs = np.random.RandomState(1)
    trace = [(rs.randint(1, jcfg.vocab_size, (plen,)), mnt, arr)
             for plen, mnt, arr in ((8, 5, 0), (12, 3, 0), (16, 6, 1),
                                    (8, 4, 2))]
    kw = dict(max_len=24, n_slots=2)
    teng = tengine.ServeEngine(from_jax_tree(tree, device="cpu"),
                               _tcfg(jcfg), tengine.ServeConfig(**kw),
                               device="cpu")
    jeng = jengine.ServeEngine(tree, jcfg, jengine.ServeConfig(**kw))
    out = []
    for eng in (teng, jeng):
        reqs = [eng.submit(p, m, arrival=a) for p, m, a in trace]
        eng.run()
        out.append(([list(r.tokens) for r in reqs], eng.stats))
    assert out[0] == out[1]
    assert teng.telemetry == []
